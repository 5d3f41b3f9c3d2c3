// Non-causal flash attention forward for Hopper (sm_90a), bf16 in, fp32 softmax.
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
// are a second ceiling of the same order on the SFUs, so the bounded mode
// (no running max, no rescale of the accumulator) is the default.
//
// Design (simple and right first; wgmma, TMA and warp specialisation are later work):
//   * grid (ceil(Sq/128), B*H); 8 warps per block, 16 query rows per warp;
//   * K/V tiles of 64 keys double-buffered in shared memory with cp.async,
//     rows padded to 72 elements so every fragment read is bank-conflict free;
//   * mma.sync m16n8k16 bf16 products with fp32 accumulation; the S
//     accumulator is re-packed in registers as the A operand of P.V;
//   * softmax state (running max, row sum) and the output accumulator in fp32
//     registers; exponentials as exp2 with log2(e) folded into the scale.
//
// Modes (BOUNDED template flag):
//   online  : running max and rescale, exact for all inputs; lse = m + log l.
//   bounded : p = exp2(s*scale_log2 - m0) with m0 (log2 units) a per-call
//             upper bound on every logit read from device memory; no running
//             max.  Emits log l; the wrapper adds m0 back and re-runs the
//             online kernel when min log l < -55 (fp32 underflow guard).
// Rows whose keys are all masked give a zero output and a -1e30 log l.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kD = 64;             // head dim (CogVideoX 2b and 5b)
constexpr int kBQ = 128;           // query rows per block
constexpr int kBK = 64;            // keys per tile
constexpr int kWarps = kBQ / 16;   // one m16 row slab per warp
constexpr int kThreads = kWarps * 32;
constexpr int kLds = kD + 8;       // padded shared-memory row, in elements
constexpr float kNegBig = -1e30f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000u); }

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  float* lse;               // [B, H, Sq] or null
  const uint8_t* key_mask;  // [Skv], nonzero = key excluded, or null
  const float* m0_log2;     // bounded mode: device scalar, the logit offset
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  int H, Sq, Skv;
  float scale_log2;         // softmax scale * log2(e)
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; src_bytes == 0 zero-fills the destination.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const int src_bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void mma_bf16_16816(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t load_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <bool BOUNDED>
__global__ void __launch_bounds__(kThreads, 2) flash_fwd_kernel(const Params p) {
  __shared__ __align__(16) __nv_bfloat16 k_s[2][kBK * kLds];
  __shared__ __align__(16) __nv_bfloat16 v_s[2][kBK * kLds];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // fragment row group
  const int t4 = lane & 3;  // thread within the group
  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y % p.H;
  const int row0 = blockIdx.x * kBQ + warp * 16 + g;  // this thread's rows: row0, row0 + 8
  const int row1 = row0 + 8;

  const __nv_bfloat16* qp = p.q + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kp = p.k + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* vp = p.v + b * p.v_sb + h * p.v_sh;

  // A fragments of the warp's 16 query rows, all 64 dims (4 k16 chunks).
  uint32_t qf[4][4];
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
    const int c = kc * 16 + t4 * 2;
    qf[kc][0] = row0 < p.Sq ? load_u32(qp + row0 * p.q_ss + c) : 0u;
    qf[kc][1] = row1 < p.Sq ? load_u32(qp + row1 * p.q_ss + c) : 0u;
    qf[kc][2] = row0 < p.Sq ? load_u32(qp + row0 * p.q_ss + c + 8) : 0u;
    qf[kc][3] = row1 < p.Sq ? load_u32(qp + row1 * p.q_ss + c + 8) : 0u;
  }

  auto load_tile = [&](int tile, int buf) {
    const int kbase = tile * kBK;
#pragma unroll
    for (int i = tid; i < kBK * (kD / 8); i += kThreads) {
      const int r = i >> 3;
      const int ch = (i & 7) * 8;
      const int key = kbase + r;
      const bool ok = key < p.Skv;
      const long long kk = ok ? key : 0;
      cp_async16(&k_s[buf][r * kLds + ch], kp + kk * p.k_ss + ch, ok);
      cp_async16(&v_s[buf][r * kLds + ch], vp + kk * p.v_ss + ch, ok);
    }
  };

  float o_acc[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    o_acc[nt][0] = o_acc[nt][1] = o_acc[nt][2] = o_acc[nt][3] = 0.f;
  }
  float m_run[2] = {kNegBig, kNegBig};  // online: running max, log2 units
  float l_run[2] = {0.f, 0.f};          // this thread's share of the row sums
  const float m0 = BOUNDED ? *p.m0_log2 : 0.f;

  const int n_tiles = (p.Skv + kBK - 1) / kBK;
  load_tile(0, 0);
  cp_async_commit();

  for (int j = 0; j < n_tiles; ++j) {
    const int buf = j & 1;
    if (j + 1 < n_tiles) {
      load_tile(j + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // S = Q K^T: 16 rows x 64 keys per warp, 8 n8 tiles.
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {
        const __nv_bfloat16* kr = &k_s[buf][(nt * 8 + g) * kLds + kc * 16 + t4 * 2];
        const uint32_t bf[2] = {load_u32(kr), load_u32(kr + 8)};
        mma_bf16_16816(s[nt], qf[kc], bf);
      }
    }

    // scale to log2 units; excluded keys (ragged tail, pad mask) get -inf
    const int kbase = j * kBK;
    const bool need_mask = (kbase + kBK > p.Skv) || (p.key_mask != nullptr);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nt][e] * p.scale_log2;
        if (need_mask) {
          const int key = kbase + nt * 8 + t4 * 2 + (e & 1);
          const bool valid = key < p.Skv && (p.key_mask == nullptr || p.key_mask[key] == 0);
          x = valid ? x : neg_inf();
        }
        s[nt][e] = x;
      }
    }

    if (BOUNDED) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = fast_exp2(s[nt][e] - m0);
      }
    } else {
      float mx0 = m_run[0], mx1 = m_run[1];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
        mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float a0 = fast_exp2(m_run[0] - mx0);
      const float a1 = fast_exp2(m_run[1] - mx1);
      m_run[0] = mx0;
      m_run[1] = mx1;
      l_run[0] *= a0;
      l_run[1] *= a1;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        o_acc[nt][0] *= a0;
        o_acc[nt][1] *= a0;
        o_acc[nt][2] *= a1;
        o_acc[nt][3] *= a1;
        s[nt][0] = fast_exp2(s[nt][0] - mx0);
        s[nt][1] = fast_exp2(s[nt][1] - mx0);
        s[nt][2] = fast_exp2(s[nt][2] - mx1);
        s[nt][3] = fast_exp2(s[nt][3] - mx1);
      }
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      l_run[0] += s[nt][0] + s[nt][1];
      l_run[1] += s[nt][2] + s[nt][3];
    }

    // O += P V: P re-packed from the S accumulator as bf16 A fragments.
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      const uint32_t pa[4] = {
          pack_bf16x2(s[2 * kc][0], s[2 * kc][1]),
          pack_bf16x2(s[2 * kc][2], s[2 * kc][3]),
          pack_bf16x2(s[2 * kc + 1][0], s[2 * kc + 1][1]),
          pack_bf16x2(s[2 * kc + 1][2], s[2 * kc + 1][3]),
      };
      const uint16_t* vr =
          reinterpret_cast<const uint16_t*>(&v_s[buf][(kc * 16 + t4 * 2) * kLds + g]);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const uint16_t* vc = vr + nt * 8;
        const uint32_t bf[2] = {
            uint32_t(vc[0]) | (uint32_t(vc[kLds]) << 16),
            uint32_t(vc[8 * kLds]) | (uint32_t(vc[9 * kLds]) << 16),
        };
        mma_bf16_16816(o_acc[nt], pa, bf);
      }
    }
    __syncthreads();  // the next iteration's copy overwrites this buffer
  }

  // full row sums: reduce over the four threads that share a row
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }

  __nv_bfloat16* op = p.o + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r == 0 ? row0 : row1;
    if (row >= p.Sq) continue;
    const float l = l_run[r];
    const float inv = l > 0.f ? 1.f / l : 0.f;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const uint32_t packed = pack_bf16x2(o_acc[nt][2 * r] * inv, o_acc[nt][2 * r + 1] * inv);
      *reinterpret_cast<uint32_t*>(op + row * p.o_ss + nt * 8 + t4 * 2) = packed;
    }
    if (p.lse != nullptr && t4 == 0) {
      float out = kNegBig;
      if (l > 0.f) out = BOUNDED ? logf(l) : m_run[r] * kLn2 + logf(l);
      p.lse[((long long)b * p.H + h) * p.Sq + row] = out;
    }
  }
}

}  // namespace

extern "C" int s2v_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse, const void* key_mask,
    const void* m0_log2, int batch, int heads, int sq, int skv,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    float scale_log2, int bounded, void* stream) {
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.lse = static_cast<float*>(lse);
  p.key_mask = static_cast<const uint8_t*>(key_mask);
  p.m0_log2 = static_cast<const float*>(m0_log2);
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.o_sb = o_sb; p.o_ss = o_ss; p.o_sh = o_sh;
  p.H = heads;
  p.Sq = sq;
  p.Skv = skv;
  p.scale_log2 = scale_log2;
  const dim3 grid((sq + kBQ - 1) / kBQ, batch * heads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bounded) {
    flash_fwd_kernel<true><<<grid, kThreads, 0, s>>>(p);
  } else {
    flash_fwd_kernel<false><<<grid, kThreads, 0, s>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}
