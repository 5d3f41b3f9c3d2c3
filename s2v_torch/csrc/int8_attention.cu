// Non-causal flash attention with an int8 q.k^T for Hopper (sm_90a): int8
// q and k, bf16 v, fp32 online softmax, bf16 out; and the int8 pre-pass that
// quantizes q and k for it.
//
// Replaces the TPU kernel B3, s2v_tpu/ops/pallas/int8_attention.py::
// flash_attention_qk_int8 (_int8_kernel), and the quantize its wrapper runs in
// XLA before the kernel (_quantize_tensor over scale*q and over k).  Same
// contract, not the Mosaic layout: the TPU pre-transposes K to [d, S], pads S
// to the key block, routes a -1e30 tail-mask row through the index map and
// appends a ones column to V for the row sums.  Here q/k/v are read in their
// [B, S, H, d] layout by TMA, the ragged key tail is a predicate on the
// logits (-inf: a zero-filled int8 key would give logit 0 and, when every
// real logit of a row is below about -40, pin the running max and underflow
// the real probabilities), and the row sums are kept in registers.
//
// Pre-pass (entry s2v_int8_prepass, two kernels, no host sync): scale*q and k
// each get one symmetric int8 scale over the WHOLE tensor (every batch row
// and head, so the CFG halves share it).  s2v_i8attn_amax_kernel reduces
// max|scale*q| and max|k| into two fp32 scalars on the device (atomicMax on
// the bits of non-negative floats: order-free, so deterministic);
// s2v_i8attn_quantize_kernel reads them and writes q_i8, k_i8 and
// dq = qs*ks.  The arithmetic is the plain version's (kernels/int8_attention.py
// int8_prepass), bit for bit: x = float(q)*scale in fp32, s = amax == 0 ? 1 :
// amax * fp32(1/127), clamp(round-half-even(x / s), +-127) with an IEEE
// division.  The quantize stays out of the main kernel: quantizing K there
// would redo each key tile for every one of the ceil(S/128) query blocks of
// a (b, h).
//
// Bound on an H100 SXM at the main-path shape (B=2, H=48, S=19,126, d=64):
// q.k^T is 2*B*H*S^2*d = 4.5e12 int8 operations (2.27 ms at 1,979 TOPS) and
// P.V 4.5e12 bf16 operations (4.55 ms at 989 TFLOP/s): 6.8 ms on the tensor
// cores.  The B*H*S^2 = 3.5e10 exponentials run on the SFUs at 16 a clock
// per SM (132 x 16 x 1.98 GHz = 4.2e12 a second): 8.4 ms, the binding
// ceiling, because int8 halves the first product and leaves the
// exponentials alone.  q/k/v/o traffic is under 1 GB (0.3 ms); the pre-pass
// moves ~1.2 GB (q and k read twice in bf16, written once in int8), ~0.35 ms.
//
// Design (kernel B1's, flash_attention.cu, with an int8 first product and q
// in shared memory as in B4, banded_attention.cu; the layer is hopper.cuh):
//   * grid (ceil(Sq/128), B*H); 2 warpgroups per block, each owning 64 query
//     rows, and 2 blocks per SM, so 4 warpgroups share an SM's SFUs and
//     tensor cores.  No producer warpgroup: q in shared memory frees the 16
//     registers of B1's q fragment, so a consumer fits the 128 registers
//     that two 256-thread blocks leave it, and one thread of the block issues
//     the TMA loads kStages - 1 tiles ahead.  On the H100 this layout beat
//     B1's (a producer warpgroup and 2 consumers, one block per SM), 3
//     consumers with a producer, and 3 or 4 consumers without one, all
//     bit for bit equal (a probe not kept in the repo, so no figures here);
//   * q_i8: one TMA box of 128 rows x 64 bytes, 64B-swizzled, kept in shared
//     memory as the A operand; K (int8, 8 KB) and V (bf16, 16 KB) stream in
//     128-key tiles through a ring of kStages stages, full/empty mbarriers;
//   * S = q.K^T is wgmma m64n128k32 s32.s8.s8, both operands from shared
//     memory, two k32 steps over d = 64 (B1 needs four k16 steps);
//   * the int32 logits become fp32 by exact_i2f (an integer add and a float
//     subtract at full rate: a cvt runs on the SFU's 16 a clock and would
//     double the exponentials' ceiling); the dq*log2(e) scale and the
//     running max are one FMA; online softmax in ex2.approx; masking only
//     on the last, ragged key tile;
//   * P re-packed to bf16 registers as the A operand of O += P.V (wgmma
//     m64n64k16, V read MN-major), exactly B1's; a row with l == 0 gives a
//     zero row; the two consumer warpgroups run independently, so one's
//     exponentials overlap the other's products.
// Entry s2v_int8_qk_tile runs one s8 wgmma tile (64 x 128 x 64) through the
// same TMA map and descriptors, for the card test of the 64B-swizzle layer.

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kD = 64;            // head dim (CogVideoX 2b and 5b)
constexpr int kRowsPerWg = 64;    // query rows of one consumer warpgroup
constexpr int kConsumers = 2;     // consumer warpgroups
constexpr int kBQ = kRowsPerWg * kConsumers;
constexpr int kBK = 128;          // keys per tile
constexpr int kStages = 4;
constexpr int kThreads = 128 * kConsumers;
constexpr uint32_t kQTileBytes = kBQ * kD;      // int8
constexpr uint32_t kKTileBytes = kBK * kD;      // int8
constexpr uint32_t kVTileBytes = kBK * kD * 2;  // bf16
constexpr float kNegBig = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

struct Smem {
  __nv_bfloat16 v[kStages][kBK * kD];  // 16 KB each, so every tile below stays 1024-aligned
  int8_t k[kStages][kBK * kD];         // 8 KB each
  int8_t q[kBQ * kD];                  // 8 KB; each warpgroup's half starts 512-aligned
  uint64_t full[kStages];
  uint64_t empty[kStages];
  uint64_t q_full;
};
constexpr int kSmemBytes = sizeof(Smem) + 1024;

struct Params {
  CUtensorMap q_map;  // int8, box (64, kBQ)
  CUtensorMap k_map;  // int8, box (64, kBK)
  CUtensorMap v_map;  // bf16, box (64, kBK)
  __nv_bfloat16* o;
  const float* dq;    // device scalar: qs * ks
  long long o_sb, o_ss, o_sh;
  int H, Sq, Skv;
};

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000u); }

// int32 -> fp32, exact for |x| < 2^22 (here |acc| <= 127^2 * 64 < 2^20): the
// bits of 1.5 * 2^23 plus x are the float 1.5 * 2^23 + x.
__device__ __forceinline__ float exact_i2f(int x) { return __int_as_float(x + 0x4B400000) - 12582912.0f; }

// K and V of key tile j into its stage
__device__ __forceinline__ void load_kv_tile(const Params& p, Smem& sm, int j, int b, int h) {
  const int st = j % kStages;
  mbar_arrive_expect_tx(&sm.full[st], kKTileBytes + kVTileBytes);
  tma_load_rows(sm.k[st], &p.k_map, &sm.full[st], j * kBK, h, b);
  tma_load_rows(sm.v[st], &p.v_map, &sm.full[st], j * kBK, h, b);
}

__device__ __forceinline__ void consumer(const Params& p, Smem& sm, int wg, int b, int h) {
  const int tid = threadIdx.x & 127;
  const int lane = tid & 31;
  const int t = lane & 3;
  const int row0 = blockIdx.x * kBQ + wg * kRowsPerWg + (tid >> 5) * 16 + (lane >> 2);  // and row0 + 8
  const int8_t* q_s = sm.q + wg * kRowsPerWg * kD;  // this warpgroup's 64 rows

  float o_acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o_acc[i] = 0.f;
  float m_run[2] = {kNegBig, kNegBig};  // running max, log2 units
  float l_run[2] = {0.f, 0.f};          // this thread's share of the row sums
  const float c = *p.dq * kLog2e;       // > 0: logits in log2 units
  mbar_wait(&sm.q_full, 0);

  const int n_tiles = (p.Skv + kBK - 1) / kBK;
  int acc[64];
  float s[64];
  for (int j = 0; j < n_tiles; ++j) {
    if (threadIdx.x == 0) {
      // the producer's step: tile j + kStages - 1 into the stage tile j - 1
      // used, once both warpgroups are done with it (round 0 passes at once)
      const int jn = j + kStages - 1;
      if (jn < n_tiles) {
        const int sn = jn % kStages;
        mbar_wait(&sm.empty[sn], ((jn / kStages) & 1) ^ 1);
        load_kv_tile(p, sm, jn, b, h);
      }
    }
    __syncwarp();
    const int st = j % kStages;
    mbar_wait(&sm.full[st], (j / kStages) & 1);

    // S = q K^T in int32: 64 rows x 128 keys, two k32 steps
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      mma_m64n128k32_s8_ss(acc, desc_kmajor_s8(q_s, kk), desc_kmajor_s8(sm.k[st], kk), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
#pragma unroll
    for (int i = 0; i < 64; ++i) s[i] = exact_i2f(acc[i]);

    // keys past Skv (zero-filled by TMA in the last tile) get -inf
    const int kbase = j * kBK;
    if (kbase + kBK > p.Skv) {
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        const int col = (i >> 2) * 8 + t * 2 + (i & 1);
        if (kbase + col >= p.Skv) s[i] = neg_inf();
      }
    }

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
    // the max in log2 units; every tile holds at least one real key
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
      l_run[0] += s[4 * j8] + s[4 * j8 + 1];
      l_run[1] += s[4 * j8 + 2] + s[4 * j8 + 3];
    }

    // O += P V: P re-packed from the S accumulator as bf16 A fragments
    uint32_t pa[8][4];
#pragma unroll
    for (int kc = 0; kc < 8; ++kc) acc_to_a(pa[kc], s, kc);
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < 8; ++kc) mma_m64n64k16_rs<1>(o_acc, pa[kc], desc_mnmajor(sm.v[st], kc), 1);
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
  }
  // l == 0 -> l = 1 over a zero accumulator: a zero row
  const float inv0 = l_run[0] > 0.f ? 1.f / l_run[0] : 0.f;
  const float inv1 = l_run[1] > 0.f ? 1.f / l_run[1] : 0.f;
  store_rows(p.o + b * p.o_sb + h * p.o_sh, p.o_ss, row0, p.Sq, o_acc, inv0, inv1, t);
}

__global__ void __launch_bounds__(kThreads, 2) s2v_i8attn_fwd_kernel(const __grid_constant__ Params p) {
  extern __shared__ uint8_t smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(align_1024(smem_raw));
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);  // warp-uniform
  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y % p.H;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&sm.full[st], 1);
      mbar_init(&sm.empty[st], kConsumers * 4);  // one arrival per consumer warp
    }
    mbar_init(&sm.q_full, 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x == 0) {
    prefetch_tensor_map(&p.q_map);
    prefetch_tensor_map(&p.k_map);
    prefetch_tensor_map(&p.v_map);
    // rows past Sq arrive as zeros; their results are never stored
    mbar_arrive_expect_tx(&sm.q_full, kQTileBytes);
    tma_load_rows(sm.q, &p.q_map, &sm.q_full, blockIdx.x * kBQ, h, b);
    const int n_tiles = (p.Skv + kBK - 1) / kBK;
    for (int j = 0; j < kStages - 1 && j < n_tiles; ++j) load_kv_tile(p, sm, j, b, h);
  }
  consumer(p, sm, wg, b, h);
}

// ------------------------------------------------------------------ pre-pass

constexpr int kPrepThreads = 256;
constexpr int kPrepBlocksPerSm = 8;  // 2,048 threads an SM: enough 16-byte loads in flight
// ops/quant.py's INV_127 (the double 1/127) as PyTorch rounds a scalar
// operand of an fp32 multiply: to the nearest fp32
constexpr float kInv127 = static_cast<float>(1.0 / 127.0);

// q's rows and then k's rows as one list of 64-element rows; a chunk is 8
// bf16 (16 bytes) of a row
struct PrepassParams {
  const __nv_bfloat16* src[2];  // q, k: [B, S, H, 64], rows contiguous
  int8_t* dst[2];               // q_i8, k_i8: [B, S, H, 64], contiguous
  unsigned int* amax;           // [2]: the fp32 bits of max|scale*q| and max|k|
  float* dq;                    // [1]: qs * ks
  long long sb[2], ss[2], sh[2];
  int seq[2];
  int rows_q;  // B * Sq * H
  int rows;    // rows_q + B * Skv * H
  int H;
  float scale;  // applied to q only
};

// Chunk c: its tensor (0 = q, 1 = k), its row within that tensor and its
// 8 values in fp32 (q's times scale).
__device__ __forceinline__ void load_chunk(const PrepassParams& p, long long c, int& which, int& row,
                                           float (&x)[8]) {
  const int r = static_cast<int>(c >> 3);
  which = r >= p.rows_q ? 1 : 0;
  row = which ? r - p.rows_q : r;
  // selects, not p.x[which]: a runtime index into the parameters would copy them to the stack
  const int seq = which ? p.seq[1] : p.seq[0];
  const int h = row % p.H;
  const int bs = row / p.H;
  const int s = bs % seq;
  const int b = bs / seq;
  const __nv_bfloat16* src = (which ? p.src[1] : p.src[0]) + b * (which ? p.sb[1] : p.sb[0]) +
                             s * (which ? p.ss[1] : p.ss[0]) + h * (which ? p.sh[1] : p.sh[0]) + (c & 7) * 8;
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(src));
  const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
  const float sc = which ? 1.f : p.scale;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&words[i]));
    x[2 * i] = __fmul_rn(f.x, sc);
    x[2 * i + 1] = __fmul_rn(f.y, sc);
  }
}

__global__ void __launch_bounds__(kPrepThreads) s2v_i8attn_amax_kernel(const PrepassParams p) {
  __shared__ float part[2][kPrepThreads / 32];
  float mq = 0.f, mk = 0.f;
  const long long n = static_cast<long long>(p.rows) * 8;
  for (long long c = blockIdx.x * (long long)blockDim.x + threadIdx.x; c < n; c += (long long)gridDim.x * blockDim.x) {
    int which, row;
    float x[8];
    load_chunk(p, c, which, row, x);
    float m = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) m = fmaxf(m, fabsf(x[i]));
    if (which) mk = fmaxf(mk, m);
    else mq = fmaxf(mq, m);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    mq = fmaxf(mq, __shfl_xor_sync(0xffffffffu, mq, off));
    mk = fmaxf(mk, __shfl_xor_sync(0xffffffffu, mk, off));
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    part[0][warp] = mq;
    part[1][warp] = mk;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kPrepThreads / 32; ++w) {
      mq = fmaxf(mq, part[0][w]);
      mk = fmaxf(mk, part[1][w]);
    }
    // non-negative floats order as their bits
    atomicMax(&p.amax[0], __float_as_uint(mq));
    atomicMax(&p.amax[1], __float_as_uint(mk));
  }
}

__device__ __forceinline__ uint32_t pack_s8x4(const int* v) {
  return (uint32_t(v[0]) & 0xFFu) | ((uint32_t(v[1]) & 0xFFu) << 8) | ((uint32_t(v[2]) & 0xFFu) << 16) |
         (uint32_t(v[3]) << 24);
}

__global__ void __launch_bounds__(kPrepThreads) s2v_i8attn_quantize_kernel(const PrepassParams p) {
  const float aq = __uint_as_float(p.amax[0]);
  const float ak = __uint_as_float(p.amax[1]);
  const float sq = aq == 0.f ? 1.f : __fmul_rn(aq, kInv127);
  const float sk = ak == 0.f ? 1.f : __fmul_rn(ak, kInv127);
  if (blockIdx.x == 0 && threadIdx.x == 0) *p.dq = __fmul_rn(sq, sk);
  const long long n = static_cast<long long>(p.rows) * 8;
  for (long long c = blockIdx.x * (long long)blockDim.x + threadIdx.x; c < n; c += (long long)gridDim.x * blockDim.x) {
    int which, row;
    float x[8];
    load_chunk(p, c, which, row, x);
    const float s = which ? sk : sq;
    int v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = min(max(__float2int_rn(__fdiv_rn(x[i], s)), -127), 127);
    const uint2 packed = make_uint2(pack_s8x4(v), pack_s8x4(v + 4));
    int8_t* dst = which ? p.dst[1] : p.dst[0];
    *reinterpret_cast<uint2*>(dst + static_cast<long long>(row) * kD + (c & 7) * 8) = packed;
  }
}

// ------------------------------------------------------------ one s8 tile

struct TileSmem {
  int8_t q[64 * kD];   // 4 KB
  int8_t k[kBK * kD];  // 8 KB
  uint64_t bar;
};

struct TileParams {
  CUtensorMap q_map;  // [1, 64, 1, 64] int8, box (64, 64)
  CUtensorMap k_map;  // [1, 128, 1, 64] int8, box (64, 128)
  int* out;           // [64, 128] int32
};

__global__ void __launch_bounds__(128, 1) s2v_i8attn_tile_kernel(const __grid_constant__ TileParams p) {
  extern __shared__ uint8_t smem_raw[];
  TileSmem& sm = *reinterpret_cast<TileSmem*>(align_1024(smem_raw));
  if (threadIdx.x == 0) {
    mbar_init(&sm.bar, 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_arrive_expect_tx(&sm.bar, (64 + kBK) * kD);
    tma_load_rows(sm.q, &p.q_map, &sm.bar, 0, 0, 0);
    tma_load_rows(sm.k, &p.k_map, &sm.bar, 0, 0, 0);
  }
  mbar_wait(&sm.bar, 0);
  int acc[64];
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) mma_m64n128k32_s8_ss(acc, desc_kmajor_s8(sm.q, kk), desc_kmajor_s8(sm.k, kk), kk > 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
  const int lane = threadIdx.x & 31;
  const int row0 = (threadIdx.x >> 5) * 16 + (lane >> 2);
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int row = row0 + ((i >> 1) & 1) * 8;
    const int col = (i >> 2) * 8 + (lane & 3) * 2 + (i & 1);
    p.out[row * kBK + col] = acc[i];
  }
}

}  // namespace

// Dynamic shared memory a block of the main kernel asks for, in bytes.
extern "C" int s2v_int8_attention_fwd_smem_bytes() { return kSmemBytes; }

// q_i8, k_i8 int8 and v, o bf16, all [B, S, H, 64] with element strides (rows
// contiguous and 16-byte aligned, as TMA needs); dq a device fp32 scalar.
extern "C" int s2v_int8_attention_fwd(
    const void* q, const void* k, const void* v, void* o, const void* dq,
    int batch, int heads, int sq, int skv,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    void* stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t err =
        cudaFuncSetAttribute(s2v_i8attn_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  Params p;
  int err = make_bshd_map_s8(&p.q_map, q, batch, sq, heads, q_sb, q_ss, q_sh, kBQ);
  if (err != 0) return err;
  if ((err = make_bshd_map_s8(&p.k_map, k, batch, skv, heads, k_sb, k_ss, k_sh, kBK)) != 0) return err;
  if ((err = make_bshd_map(&p.v_map, v, batch, skv, heads, v_sb, v_ss, v_sh, kBK)) != 0) return err;
  p.o = static_cast<__nv_bfloat16*>(o);
  p.dq = static_cast<const float*>(dq);
  p.o_sb = o_sb; p.o_ss = o_ss; p.o_sh = o_sh;
  p.H = heads;
  p.Sq = sq;
  p.Skv = skv;
  const dim3 grid((sq + kBQ - 1) / kBQ, batch * heads);
  s2v_i8attn_fwd_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The pre-pass: q, k bf16 [B, S, H, 64] (element strides, rows contiguous and
// 16-byte aligned) -> q_i8, k_i8 int8 [B, S, H, 64] contiguous and dq [1]
// fp32; amax is a 2-float device workspace.
extern "C" int s2v_int8_prepass(
    const void* q, const void* k, void* q_i8, void* k_i8, void* amax, void* dq,
    int batch, int heads, int sq, int skv,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    float scale, void* stream) {
  PrepassParams p;
  p.src[0] = static_cast<const __nv_bfloat16*>(q);
  p.src[1] = static_cast<const __nv_bfloat16*>(k);
  p.dst[0] = static_cast<int8_t*>(q_i8);
  p.dst[1] = static_cast<int8_t*>(k_i8);
  p.amax = static_cast<unsigned int*>(amax);
  p.dq = static_cast<float*>(dq);
  p.sb[0] = q_sb; p.ss[0] = q_ss; p.sh[0] = q_sh;
  p.sb[1] = k_sb; p.ss[1] = k_ss; p.sh[1] = k_sh;
  p.seq[0] = sq;
  p.seq[1] = skv;
  p.rows_q = batch * sq * heads;
  p.rows = p.rows_q + batch * skv * heads;
  p.H = heads;
  p.scale = scale;
  static int sms = 0;  // the card's SM count, read once
  cudaError_t err = cudaSuccess;
  if (sms == 0) {
    int device = 0;
    if ((err = cudaGetDevice(&device)) != cudaSuccess) return static_cast<int>(err);
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess) {
      return static_cast<int>(err);
    }
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((err = cudaMemsetAsync(amax, 0, 2 * sizeof(float), s)) != cudaSuccess) return static_cast<int>(err);
  const long long chunks = static_cast<long long>(p.rows) * 8;
  const long long needed = (chunks + kPrepThreads - 1) / kPrepThreads;
  const long long most = static_cast<long long>(sms) * kPrepBlocksPerSm;
  const int blocks = static_cast<int>(needed < most ? needed : most);
  s2v_i8attn_amax_kernel<<<blocks, kPrepThreads, 0, s>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  s2v_i8attn_quantize_kernel<<<blocks, kPrepThreads, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// One s8 wgmma tile: out[64, 128] int32 = q_i8[64, 64] . k_i8[128, 64]^T,
// both contiguous, through the main kernel's TMA maps and descriptors.
extern "C" int s2v_int8_qk_tile(const void* q, const void* k, void* out, void* stream) {
  TileParams p;
  int err = make_bshd_map_s8(&p.q_map, q, 1, 64, 1, 64 * kD, kD, kD, 64);
  if (err != 0) return err;
  if ((err = make_bshd_map_s8(&p.k_map, k, 1, kBK, 1, kBK * kD, kD, kD, kBK)) != 0) return err;
  p.out = static_cast<int*>(out);
  s2v_i8attn_tile_kernel<<<1, 128, sizeof(TileSmem) + 1024, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
