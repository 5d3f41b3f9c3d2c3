// Non-causal flash attention forward for Hopper (sm_90a), bf16 or fp16 in, fp32 softmax.
//
// Replaces the TPU kernel B1, s2v_tpu/ops/pallas/flash_attention.py::flash_attention
// (_flash_kernel, online softmax, and _flash_kernel_bounded, the bounded softmax),
// as ONE kernel with a template flag.  It computes the same contract, not the
// Mosaic layout tricks: q/k/v are read in their [B, S, H, d] layout through
// strides (no [B*H, S, d] relayout, no pre-transposed K, no -1e30 feature row,
// no ones column of V); the ragged key tail and the key pad mask are a
// predicate on the logits.
//
// Bound on an H100 SXM at the main-path shape (B=2, H=48, S=19,126, d=64):
// 4*B*H*S^2*d = 9.0e12 operations per call, 9.1 ms at the 989 TFLOP/s bf16
// tensor-core peak, against ~0.94 GB of q/k/v/o traffic (0.28 ms at
// 3.35 TB/s): the kernel is compute-bound.  The 3.5e10 exponentials per call
// are a second ceiling of the same size on the SFUs (16 ex2 a clock per SM,
// ~9.5 ms), so the exponentials have to run while the tensor cores work.
//
// Design (the shared Hopper layer is hopper.cuh):
//   * grid (ceil(Sq/128), B*H); 3 warpgroups per block: warpgroup 0 is the
//     producer (one thread issues TMA, setmaxnreg gives its registers away),
//     warpgroups 1 and 2 each own 64 query rows;
//   * K and V stream in 128-key tiles (16 KB each, 128B-swizzled) through a
//     ring of kStages stages, full/empty mbarriers per stage; the key pad
//     mask, when given, comes with each tile (128 bytes, padded with
//     "excluded" by the wrapper); rows past Skv arrive as zeros from TMA;
//   * q stays in registers as the A operand (read once from device memory);
//     S = q.K^T is wgmma m64n128k16 with K the K-major B operand;
//   * the softmax runs in fp32 registers with ex2.approx; P is re-packed to
//     bf16 registers as the A operand of O += P.V (wgmma m64n64k16, V read
//     MN-major with the transpose bit);
//   * overlap: the two consumer warpgroups run independently, so one's
//     exponentials can run while the other's products use the tensor cores;
//   * masking only where needed: on the last, ragged key tile and on tiles
//     with a pad mask.
// ptxas compiles the consumers within 168 registers a thread (the 384-thread
// launch bound; setmaxnreg moves registers only at run time), which this
// loop fits without spills.  Measured against it on the H100 and left out,
// each no faster or slower (PERF.md §6): issuing S_j with P_{j-1}.V_{j-1}
// and double-buffering P (it spills at 168 registers; a 256-thread block
// without a producer warpgroup avoids the spills and is slower still), a
// ping-pong of the two warpgroups on named barriers, bf16 packing by integer
// ops, and a quarter of the exponentials on the FMA pipe.
//
// Modes (BOUNDED template flag):
//   online  : running max and rescale, exact for all inputs; lse = m + log l.
//   bounded : p = exp2(s*scale_log2 - m0) with m0 (log2 units) a per-call
//             upper bound on every logit read from device memory; no running
//             max.  Emits log l; the wrapper adds m0 back and re-runs the
//             online kernel when min log l < -55 (fp32 underflow guard).
// Rows whose keys are all masked give a zero output and a -1e30 log l.
//
// fp16 in bounded mode: P is rounded to fp16 for P.V, whose normal range ends
// at 2^-14 and which flushes below 2^-24, so a row whose largest logit lies
// far below m0 would lose its P (and o = P.V / l would shrink to zero while l,
// summed in fp32, does not).  So the fp16 kernel offsets by m0 - 15 bits:
// P = 2^15 at the bound (fp16 tops out at 65,504), and every row whose
// largest P is at least 1 (largest logit within 15 bits of m0) rounds P as
// finely as the online kernel does.  A row whose largest P stays below 1
// reports log l = -1e30, so the wrapper's guard re-runs the call online.
//
// Element type (E template parameter, hopper.cuh): bf16 (the 5b models) or
// fp16 (the 2b family, s2v_torch entry s2v_flash_attention_fwd_f16), the
// same design on the same tile layouts; the products are .f32.f16.f16
// wgmma and P is rounded to fp16 for P.V (bounded mode: see above).  fp16 has the same tensor-core
// rate (989 TFLOP/s dense), so the bound is the same count of operations.
// The bf16 instantiation is the kernel as it was before fp16 came.

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kD = 64;            // head dim (CogVideoX 2b and 5b)
constexpr int kRowsPerWg = 64;    // query rows of one consumer warpgroup
constexpr int kConsumers = 2;     // consumer warpgroups
constexpr int kBQ = kRowsPerWg * kConsumers;
constexpr int kBK = 128;          // keys per tile
constexpr int kStages = 3;
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr uint32_t kTileBytes = kBK * kD * 2;
constexpr float kNegBig = -1e30f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kF16Shift = 15.f;  // fp16 bounded mode: P = 2^15 at the bound

template <typename E>
struct Smem {
  E k[kStages][kBK * kD];  // each 16 KB, so 1024-aligned
  E v[kStages][kBK * kD];
  uint8_t mask[kStages][kBK];
  uint64_t full[kStages];
  uint64_t empty[kStages];
};
constexpr int kSmemBytes = sizeof(Smem<__nv_bfloat16>) + 1024;
static_assert(sizeof(Smem<__half>) == sizeof(Smem<__nv_bfloat16>), "one layout for both types");

template <typename E>
struct Params {
  CUtensorMap k_map;  // box (64, kBK)
  CUtensorMap v_map;
  const E* q;
  E* o;
  float* lse;               // [B, H, Sq] or null
  const uint8_t* key_mask;  // [ceil(Skv / kBK) * kBK], nonzero = key excluded, or null
  const float* m0_log2;     // bounded mode: device scalar, the logit offset
  long long q_sb, q_ss, q_sh;
  long long o_sb, o_ss, o_sh;
  int H, Sq, Skv;
  float scale_log2;         // softmax scale * log2(e)
};

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000u); }

template <typename E, bool BOUNDED>
__device__ __forceinline__ void consumer(const Params<E>& p, Smem<E>& sm, int wg, int b, int h) {
  const int tid = threadIdx.x & 127;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int row0 = blockIdx.x * kBQ + wg * kRowsPerWg + (tid >> 5) * 16 + g;  // and row0 + 8

  uint32_t qa[4][4];
  load_a_rows(qa, p.q + b * p.q_sb + h * p.q_sh, p.q_ss, row0, p.Sq, t);

  float o_acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o_acc[i] = 0.f;
  float m_run[2] = {kNegBig, kNegBig};  // online: running max, log2 units
  float l_run[2] = {0.f, 0.f};          // this thread's share of the row sums
  // fp16 bounded mode: the offset lowered by kF16Shift, and each row's largest P
  constexpr bool kGuardP = BOUNDED && is_f16<E>();
  float m0 = BOUNDED ? *p.m0_log2 : 0.f;
  if constexpr (kGuardP) m0 -= kF16Shift;
  float p_max[2] = {0.f, 0.f};
  const float c = p.scale_log2;

  const int n_tiles = (p.Skv + kBK - 1) / kBK;
  float s[64];
  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % kStages;
    mbar_wait(&sm.full[st], (j / kStages) & 1);

    // S = q K^T: 64 rows x 128 keys
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) mma_m64n128k16_rs<0, E>(s, qa[kk], desc_kmajor(sm.k[st], kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    // excluded keys (ragged tail, pad mask) get -inf (online) or p = 0 (bounded)
    const int kbase = j * kBK;
    const bool need_mask = p.key_mask != nullptr || kbase + kBK > p.Skv;
    if (need_mask) {
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        const int col = (i >> 2) * 8 + t * 2 + (i & 1);
        const bool valid = p.key_mask != nullptr ? sm.mask[st][col] == 0 : kbase + col < p.Skv;
        s[i] = valid ? s[i] : neg_inf();
      }
    }

    if (BOUNDED) {
#pragma unroll
      for (int i = 0; i < 64; ++i) s[i] = fast_exp2(fmaf(s[i], c, -m0));
      if constexpr (kGuardP) {
#pragma unroll
        for (int j8 = 0; j8 < 16; ++j8) {
          p_max[0] = fmaxf(p_max[0], fmaxf(s[4 * j8], s[4 * j8 + 1]));
          p_max[1] = fmaxf(p_max[1], fmaxf(s[4 * j8 + 2], s[4 * j8 + 3]));
        }
      }
    } else {
      float mx0 = neg_inf(), mx1 = neg_inf();
#pragma unroll
      for (int j8 = 0; j8 < 16; ++j8) {
        mx0 = fmaxf(mx0, fmaxf(s[4 * j8], s[4 * j8 + 1]));
        mx1 = fmaxf(mx1, fmaxf(s[4 * j8 + 2], s[4 * j8 + 3]));
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      // the max in log2 units (scale > 0); -inf (all excluded) keeps the old max
      const float new0 = fmaxf(m_run[0], mx0 * c);
      const float new1 = fmaxf(m_run[1], mx1 * c);
      const float a0 = fast_exp2(m_run[0] - new0);
      const float a1 = fast_exp2(m_run[1] - new1);
      m_run[0] = new0;
      m_run[1] = new1;
      l_run[0] *= a0;
      l_run[1] *= a1;
#pragma unroll
      for (int j8 = 0; j8 < 8; ++j8) {
        o_acc[4 * j8 + 0] *= a0;
        o_acc[4 * j8 + 1] *= a0;
        o_acc[4 * j8 + 2] *= a1;
        o_acc[4 * j8 + 3] *= a1;
      }
#pragma unroll
      for (int j8 = 0; j8 < 16; ++j8) {
        s[4 * j8 + 0] = fast_exp2(fmaf(s[4 * j8 + 0], c, -new0));
        s[4 * j8 + 1] = fast_exp2(fmaf(s[4 * j8 + 1], c, -new0));
        s[4 * j8 + 2] = fast_exp2(fmaf(s[4 * j8 + 2], c, -new1));
        s[4 * j8 + 3] = fast_exp2(fmaf(s[4 * j8 + 3], c, -new1));
      }
    }
#pragma unroll
    for (int j8 = 0; j8 < 16; ++j8) {
      l_run[0] += s[4 * j8] + s[4 * j8 + 1];
      l_run[1] += s[4 * j8 + 2] + s[4 * j8 + 3];
    }

    // O += P V: P re-packed from the S accumulator as A fragments of E
    uint32_t pa[8][4];
#pragma unroll
    for (int kc = 0; kc < 8; ++kc) acc_to_a<E>(pa[kc], s, kc);
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < 8; ++kc) mma_m64n64k16_rs<1, E>(o_acc, pa[kc], desc_mnmajor(sm.v[st], kc), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o_acc);
    fence_regs(pa);
    if (lane == 0) mbar_arrive(&sm.empty[st]);  // this warp is done with the stage
  }

  // full row sums: reduce over the four threads that share a row
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    if constexpr (kGuardP) {
      p_max[r] = fmaxf(p_max[r], __shfl_xor_sync(0xffffffffu, p_max[r], 1));
      p_max[r] = fmaxf(p_max[r], __shfl_xor_sync(0xffffffffu, p_max[r], 2));
    }
  }
  const float inv0 = l_run[0] > 0.f ? 1.f / l_run[0] : 0.f;
  const float inv1 = l_run[1] > 0.f ? 1.f / l_run[1] : 0.f;
  store_rows(p.o + b * p.o_sb + h * p.o_sh, p.o_ss, row0, p.Sq, o_acc, inv0, inv1, t);
  if (p.lse != nullptr && t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= p.Sq) continue;
      const float l = l_run[r];
      float out = kNegBig;
      if (l > 0.f) out = BOUNDED ? logf(l) : m_run[r] * kLn2 + logf(l);
      if constexpr (kGuardP) out = p_max[r] >= 1.f ? out - kF16Shift * kLn2 : kNegBig;
      p.lse[((long long)b * p.H + h) * p.Sq + row] = out;
    }
  }
}

template <typename E, bool BOUNDED>
__global__ void __launch_bounds__(kThreads, 1) flash_fwd_kernel(const __grid_constant__ Params<E> p) {
  extern __shared__ uint8_t smem_raw[];
  Smem<E>& sm = *reinterpret_cast<Smem<E>*>(align_1024(smem_raw));
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);  // warp-uniform
  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y % p.H;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&sm.full[st], 1);
      mbar_init(&sm.empty[st], kConsumers * 4);  // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      prefetch_tensor_map(&p.k_map);
      prefetch_tensor_map(&p.v_map);
      const int n_tiles = (p.Skv + kBK - 1) / kBK;
      const uint32_t bytes = 2 * kTileBytes + (p.key_mask != nullptr ? kBK : 0);
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % kStages;
        mbar_wait(&sm.empty[st], ((j / kStages) & 1) ^ 1);  // the first round passes at once
        mbar_arrive_expect_tx(&sm.full[st], bytes);
        tma_load_rows(sm.k[st], &p.k_map, &sm.full[st], j * kBK, h, b);
        tma_load_rows(sm.v[st], &p.v_map, &sm.full[st], j * kBK, h, b);
        if (p.key_mask != nullptr) bulk_load(sm.mask[st], p.key_mask + j * kBK, kBK, &sm.full[st]);
      }
    }
  } else {
    setmaxnreg_inc<232>();
    consumer<E, BOUNDED>(p, sm, wg - 1, b, h);
  }
}

template <typename E, bool BOUNDED>
int launch(const Params<E>& p, dim3 grid, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<E, BOUNDED>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  flash_fwd_kernel<E, BOUNDED><<<grid, kThreads, kSmemBytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename E>
int forward(const void* q, const void* k, const void* v, void* o, void* lse, const void* key_mask,
            const void* m0_log2, int batch, int heads, int sq, int skv,
            long long q_sb, long long q_ss, long long q_sh,
            long long k_sb, long long k_ss, long long k_sh,
            long long v_sb, long long v_ss, long long v_sh,
            long long o_sb, long long o_ss, long long o_sh,
            float scale_log2, int bounded, void* stream) {
  Params<E> p;
  int err = make_bshd_map<E>(&p.k_map, k, batch, skv, heads, k_sb, k_ss, k_sh, kBK);
  if (err != 0) return err;
  err = make_bshd_map<E>(&p.v_map, v, batch, skv, heads, v_sb, v_ss, v_sh, kBK);
  if (err != 0) return err;
  p.q = static_cast<const E*>(q);
  p.o = static_cast<E*>(o);
  p.lse = static_cast<float*>(lse);
  p.key_mask = static_cast<const uint8_t*>(key_mask);
  p.m0_log2 = static_cast<const float*>(m0_log2);
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.o_sb = o_sb; p.o_ss = o_ss; p.o_sh = o_sh;
  p.H = heads;
  p.Sq = sq;
  p.Skv = skv;
  p.scale_log2 = scale_log2;
  const dim3 grid((sq + kBQ - 1) / kBQ, batch * heads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bounded ? launch<E, true>(p, grid, s) : launch<E, false>(p, grid, s);
}

}  // namespace

// Dynamic shared memory a block of the kernel asks for, in bytes.
extern "C" int s2v_flash_attention_fwd_smem_bytes() { return kSmemBytes; }

// key_mask, when given, holds ceil(skv / 128) * 128 bytes (the wrapper pads
// it with "excluded").  q, k, v and o are bf16.
extern "C" int s2v_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse, const void* key_mask,
    const void* m0_log2, int batch, int heads, int sq, int skv,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    float scale_log2, int bounded, void* stream) {
  return forward<__nv_bfloat16>(q, k, v, o, lse, key_mask, m0_log2, batch, heads, sq, skv, q_sb, q_ss, q_sh,
                                k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh, scale_log2, bounded, stream);
}

// The same with q, k, v and o in fp16.
extern "C" int s2v_flash_attention_fwd_f16(
    const void* q, const void* k, const void* v, void* o, void* lse, const void* key_mask,
    const void* m0_log2, int batch, int heads, int sq, int skv,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    float scale_log2, int bounded, void* stream) {
  return forward<__half>(q, k, v, o, lse, key_mask, m0_log2, batch, heads, sq, skv, q_sb, q_ss, q_sh,
                         k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh, scale_log2, bounded, stream);
}
