// Non-causal flash attention backward for Hopper (sm_90a), bf16 or fp16 in, fp32 math.
//
// Replaces the TPU kernel B2, s2v_tpu/ops/pallas/flash_attention_bwd.py::
// flash_attention_bwd (_dq_kernel and _dkv_kernel).  Given q, k, v, o, dO
// and the forward's log-sum-exp, it computes D = rowsum(dO * o) and
//   P  = exp(scale * q k^T - lse)          (per tile, never stored)
//   dV = P^T dO
//   dS = P * (dO v^T - D)
//   dQ = scale * dS k,   dK = scale * dS^T q
// It computes that contract, not the Mosaic layout tricks: q/k/v/o/dO are
// read in their [B, S, H, d] layout through strides.  Keys past Skv get P = 0
// through a predicate; queries past Sq contribute nothing (their q and dO
// rows arrive as zeros from TMA and their lse is +inf).  Sq != Skv is allowed.
//
// Bound on an H100 SXM at the training shape (B=1, H=48, S=19,126, d=64):
// the five products are 10*B*H*S^2*d = 1.12e13 operations, 11.4 ms at the
// 989 TFLOP/s bf16 tensor-core peak, against ~0.95 GB of q/k/v/o/dO/dq/dk/dv
// traffic (0.28 ms at 3.35 TB/s): compute-bound.
//
// Design (the shared Hopper layer is hopper.cuh), three kernels on one stream:
//   * prepass  - D = rowsum(dO * o) in fp32 and lse * log2(e), both into a
//                [B*H, Sq_pad] workspace whose rows past Sq hold D = 0 and
//                lse = +inf;
//   * dq       - one block per (128-query tile, b*h): q and dO stay in
//                registers, K/V stream in 64-key tiles; per tile
//                S = q K^T, dP = dO V^T, P, dS, dq += dS K;
//   * dkv      - one block per (128-key tile, b*h): K and V stay in
//                shared memory, q/dO stream in 64-query tiles with their lse and
//                D rows; per tile S^T = K q^T, dP^T = V dO^T, P^T, dS^T,
//                dV += P^T dO, dK += dS^T q.
//   Every output is written by exactly one block, so the result is the same
//   bit for bit on every run, with no atomics and no workspace for dq; q k^T
//   and dO v^T are computed twice (7 products for the 5 of the bound).
//   Both main kernels: 3 warpgroups, warpgroup 0 the TMA producer (a ring of
//   kStages stages behind full/empty mbarriers, setmaxnreg gives its
//   registers away), warpgroups 1 and 2 each own 64 rows; every product is a
//   wgmma m64n64k16 with A the resident operand (registers in the dq kernel,
//   shared memory in the dkv kernel, which holds four accumulators) or P / dS
//   re-packed from an accumulator in registers, and B a 128B-swizzled tile,
//   read K-major for q.k^T-like products and MN-major (transposed) for the
//   sums over rows.  The two consumer warpgroups run independently, so
//   one's exponentials can run while the other's products use the tensor
//   cores.
//   Exponentials as exp2 with log2(e) folded into the scale; the softmax
//   scale of dq and dk is applied in fp32 once, at the end.
// Why not one kernel of 5 products: dq would be summed across the 150 key
// blocks of a head, ~35 GB of fp32 partials at the training shape, and in a
// fixed order (bit-for-bit results) only through a chain of per-tile
// counters; the split costs two products of the seven instead.  The loop
// variants tried on B1 were tried here too and left out the same way
// (PERF.md §6).  Registers:
// ptxas compiles the consumers within 168 a thread (the 384-thread launch
// bound), so the dkv kernel keeps K and V in shared memory (SS products)
// rather than in registers, where they spilled.
//
// Element type (E template parameter, hopper.cuh): bf16 (the 5b models) or
// fp16 (the 2b family, entry s2v_flash_attention_bwd_f16), the same three
// kernels on the same tile layouts: .f32.f16.f16 wgmma, P and dS rounded to
// fp16 before their products, dq/dk/dv written in fp16.  The bf16
// instantiation is the code as it was before fp16 came.
// fp16 has no normal values below 2^-14 and flushes below 2^-24, and dS
// follows dO's scale: a training step's dO (a mean over ~10^6 latents, no
// loss scaler) would leave dS, and so dq and dk, at zero.  So the fp16
// kernels scale dS by 2^e before its rounding and dq, dk by 2^-e after,
// both exact: e (a device int the wrapper computes, ds_exp) puts the bound
// |dS| <= 2 max|dO_i| max|v_j| just under 2^14.

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kD = 64;           // head dim (CogVideoX 2b and 5b)
constexpr int kRowsPerWg = 64;   // resident rows of one consumer warpgroup
constexpr int kConsumers = 2;
constexpr int kBR = kRowsPerWg * kConsumers;  // resident rows a block owns
constexpr int kBT = 64;          // rows of each streamed tile
constexpr int kStages = 3;
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr uint32_t kTileBytes = kBT * kD * 2;  // 8 KB
constexpr float kLog2e = 1.4426950408889634f;

template <typename E>
struct Smem {
  E a[kStages][kBT * kD];  // K (dq kernel) or q (dkv kernel); 8 KB each
  E b[kStages][kBT * kD];  // V (dq kernel) or dO (dkv kernel)
  E k_res[kBR * kD];       // dkv kernel: the block's resident K and V (16 KB each)
  E v_res[kBR * kD];
  float lse2[kStages][kBT];            // dkv kernel: the tile's lse * log2(e)
  float delta[kStages][kBT];           // dkv kernel: the tile's D
  uint64_t full[kStages];
  uint64_t empty[kStages];
  uint64_t resident;                   // dkv kernel: K and V have arrived
};
constexpr int kSmemBytes = sizeof(Smem<__nv_bfloat16>) + 1024;
static_assert(sizeof(Smem<__half>) == sizeof(Smem<__nv_bfloat16>), "one layout for both types");

template <typename E>
struct Params {
  CUtensorMap k_map, v_map;   // box (64, kBT), over Skv
  CUtensorMap q_map, do_map;  // box (64, kBT), over Sq
  const E* q;
  const E* k;
  const E* v;
  const E* o;
  const E* dout;
  const float* lse;  // [B, H, Sq], natural log
  const int* ds_exp; // fp16: dS is scaled by 2^ds_exp before its rounding (null for bf16)
  float* lse2_ws;    // [B*H, Sq_pad]: lse * log2(e), +inf past Sq
  float* delta_ws;   // [B*H, Sq_pad]: rowsum(dO * o), 0 past Sq
  E* dq;
  E* dk;
  E* dv;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  long long do_sb, do_ss, do_sh;
  long long dq_sb, dq_ss, dq_sh;
  long long dk_sb, dk_ss, dk_sh;
  long long dv_sb, dv_ss, dv_sh;
  int B, H, Sq, Skv, Sq_pad;
  float scale;
  float scale_log2;  // scale * log2(e)
};

__device__ __forceinline__ float pos_inf() { return __int_as_float(0x7f800000u); }

// The factor on dS before its rounding, and the one on the dq / dk sums
// (the softmax scale, and in fp16 the inverse of the first).
template <typename E>
__device__ __forceinline__ void ds_scales(const Params<E>& p, float& ds_up, float& out_scale) {
  ds_up = 1.f;
  out_scale = p.scale;
  if constexpr (is_f16<E>()) {
    const int e = *p.ds_exp;
    ds_up = scalbnf(1.f, e);
    out_scale = scalbnf(p.scale, -e);
  }
}

// ------------------------------------------------------------------ prepass

// One row of 64 per 8 threads (16 bytes each); rows in [b*h][Sq_pad] order.
constexpr int kPrepassThreads = 256;

template <typename E>
__global__ void __launch_bounds__(kPrepassThreads) flash_bwd_prepass_kernel(const __grid_constant__ Params<E> p) {
  const long long idx = (long long)blockIdx.x * (kPrepassThreads / 8) + (threadIdx.x >> 3);
  const int part = threadIdx.x & 7;
  const bool in_range = idx < (long long)p.B * p.H * p.Sq_pad;  // every lane reaches the shuffles
  const int bh = int(idx / p.Sq_pad);
  const int row = int(idx % p.Sq_pad);
  const int b = bh / p.H;
  const int h = bh % p.H;
  float acc = 0.f;
  if (in_range && row < p.Sq) {
    const uint4 ov = *reinterpret_cast<const uint4*>(p.o + b * p.o_sb + row * p.o_ss + h * p.o_sh + part * 8);
    const uint4 gv =
        *reinterpret_cast<const uint4*>(p.dout + b * p.do_sb + row * p.do_ss + h * p.do_sh + part * 8);
    const uint32_t* o2 = reinterpret_cast<const uint32_t*>(&ov);
    const uint32_t* g2 = reinterpret_cast<const uint32_t*>(&gv);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 of = unpack_x2<E>(o2[i]);
      const float2 gf = unpack_x2<E>(g2[i]);
      acc = fmaf(of.x, gf.x, acc);
      acc = fmaf(of.y, gf.y, acc);
    }
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  acc += __shfl_xor_sync(0xffffffffu, acc, 2);
  acc += __shfl_xor_sync(0xffffffffu, acc, 4);
  if (in_range && part == 0) {
    p.delta_ws[idx] = acc;
    p.lse2_ws[idx] = row < p.Sq ? p.lse[(long long)bh * p.Sq + row] * kLog2e : pos_inf();
  }
}

// ------------------------------------------------------------ shared parts

// Producer: streams n_tiles tiles of two operands (and, for the dkv kernel,
// the lse / D rows of each tile) through the ring.
template <bool WITH_ROWS, typename E>
__device__ __forceinline__ void produce(const Params<E>& p, Smem<E>& sm, const CUtensorMap* map_a,
                                        const CUtensorMap* map_b, int n_tiles, int b, int h) {
  prefetch_tensor_map(map_a);
  prefetch_tensor_map(map_b);
  const long long ws_row = ((long long)b * p.H + h) * p.Sq_pad;
  const uint32_t bytes = 2 * kTileBytes + (WITH_ROWS ? 2 * kBT * 4 : 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % kStages;
    mbar_wait(&sm.empty[st], ((j / kStages) & 1) ^ 1);  // the first round passes at once
    mbar_arrive_expect_tx(&sm.full[st], bytes);
    tma_load_rows(sm.a[st], map_a, &sm.full[st], j * kBT, h, b);
    tma_load_rows(sm.b[st], map_b, &sm.full[st], j * kBT, h, b);
    if (WITH_ROWS) {
      bulk_load(sm.lse2[st], p.lse2_ws + ws_row + j * kBT, kBT * 4, &sm.full[st]);
      bulk_load(sm.delta[st], p.delta_ws + ws_row + j * kBT, kBT * 4, &sm.full[st]);
    }
  }
}

template <typename E>
__device__ __forceinline__ void init_ring(Smem<E>& sm) {
  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&sm.full[st], 1);
      mbar_init(&sm.empty[st], kConsumers * 4);  // one arrival per consumer warp
    }
    mbar_init(&sm.resident, 1);
    fence_barrier_init();
  }
  __syncthreads();
}

__device__ __forceinline__ void zero(float (&acc)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
}

// --------------------------------------------------------------- dq kernel

template <typename E>
__device__ __forceinline__ void dq_consumer(const Params<E>& p, Smem<E>& sm, int wg, int b, int h) {
  const int tid = threadIdx.x & 127;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int row0 = blockIdx.x * kBR + wg * kRowsPerWg + (tid >> 5) * 16 + g;  // and row0 + 8

  uint32_t qa[4][4], da[4][4];
  load_a_rows(qa, p.q + b * p.q_sb + h * p.q_sh, p.q_ss, row0, p.Sq, t);
  load_a_rows(da, p.dout + b * p.do_sb + h * p.do_sh, p.do_ss, row0, p.Sq, t);
  const long long ws_row = ((long long)b * p.H + h) * p.Sq_pad;
  // rows past Sq: P = 0, so they add nothing (and are not written)
  const float lse0 = row0 < p.Sq ? p.lse2_ws[ws_row + row0] : pos_inf();
  const float lse1 = row0 + 8 < p.Sq ? p.lse2_ws[ws_row + row0 + 8] : pos_inf();
  const float d0 = row0 < p.Sq ? p.delta_ws[ws_row + row0] : 0.f;
  const float d1 = row0 + 8 < p.Sq ? p.delta_ws[ws_row + row0 + 8] : 0.f;
  const float c = p.scale_log2;
  float ds_up, out_scale;
  ds_scales(p, ds_up, out_scale);

  float dq_acc[32];
  zero(dq_acc);
  float s[32], dp[32];
  const int n_tiles = (p.Skv + kBT - 1) / kBT;
  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % kStages;
    mbar_wait(&sm.full[st], (j / kStages) & 1);

    // S = q K^T, dP = dO V^T: 64 rows x 64 keys each
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) mma_m64n64k16_rs<0, E>(s, qa[kk], desc_kmajor(sm.a[st], kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) mma_m64n64k16_rs<0, E>(dp, da[kk], desc_kmajor(sm.b[st], kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    const int kbase = j * kBT;
    const bool ragged = kbase + kBT > p.Skv;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const bool hi = (i & 2) != 0;
      float pv = fast_exp2(fmaf(s[i], c, hi ? -lse1 : -lse0));
      if (ragged && kbase + (i >> 2) * 8 + t * 2 + (i & 1) >= p.Skv) pv = 0.f;
      s[i] = pv * (dp[i] - (hi ? d1 : d0));  // dS
      if constexpr (is_f16<E>()) s[i] *= ds_up;
    }

    // dq += dS K
    uint32_t dsa[4][4];
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) acc_to_a<E>(dsa[kc], s, kc);
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) mma_m64n64k16_rs<1, E>(dq_acc, dsa[kc], desc_mnmajor(sm.a[st], kc), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq_acc);
    fence_regs(dsa);
    if (lane == 0) mbar_arrive(&sm.empty[st]);
  }
  store_rows(p.dq + b * p.dq_sb + h * p.dq_sh, p.dq_ss, row0, p.Sq, dq_acc, out_scale, out_scale, t);
}

template <typename E>
__global__ void __launch_bounds__(kThreads, 1) flash_bwd_dq_kernel(const __grid_constant__ Params<E> p) {
  extern __shared__ uint8_t smem_raw[];
  Smem<E>& sm = *reinterpret_cast<Smem<E>*>(align_1024(smem_raw));
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);  // warp-uniform
  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y % p.H;
  init_ring(sm);
  if (wg == 0) {
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) produce<false>(p, sm, &p.k_map, &p.v_map, (p.Skv + kBT - 1) / kBT, b, h);
  } else {
    setmaxnreg_inc<232>();
    dq_consumer(p, sm, wg - 1, b, h);
  }
}

// -------------------------------------------------------------- dkv kernel

template <typename E>
__device__ __forceinline__ void dkv_consumer(const Params<E>& p, Smem<E>& sm, int wg, int b, int h) {
  const int tid = threadIdx.x & 127;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int key0 = blockIdx.x * kBR + wg * kRowsPerWg + (tid >> 5) * 16 + g;  // and key0 + 8

  // this warpgroup's 64 resident keys (rows past Skv arrived as zeros)
  const E* k_res = sm.k_res + wg * kRowsPerWg * kD;
  const E* v_res = sm.v_res + wg * kRowsPerWg * kD;
  mbar_wait(&sm.resident, 0);
  const float c = p.scale_log2;
  float ds_up, out_scale;
  ds_scales(p, ds_up, out_scale);

  float dk_acc[32], dv_acc[32];
  zero(dk_acc);
  zero(dv_acc);
  float s[32], dp[32];
  const int n_tiles = (p.Sq + kBT - 1) / kBT;
  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % kStages;
    mbar_wait(&sm.full[st], (j / kStages) & 1);

    // S^T = K q^T, dP^T = V dO^T: 64 keys x 64 queries each
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      mma_m64n64k16_ss<0, E>(s, desc_kmajor(k_res, kk), desc_kmajor(sm.a[st], kk), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      mma_m64n64k16_ss<0, E>(dp, desc_kmajor(v_res, kk), desc_kmajor(sm.b[st], kk), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    // columns are queries: their lse and D come with the tile
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int col = (i >> 2) * 8 + t * 2 + (i & 1);
      s[i] = fast_exp2(fmaf(s[i], c, -sm.lse2[st][col]));       // P^T
      dp[i] = s[i] * (dp[i] - sm.delta[st][col]);               // dS^T
      if constexpr (is_f16<E>()) dp[i] *= ds_up;
    }

    // dV += P^T dO, dK += dS^T q
    uint32_t pa[4][4], dsa[4][4];
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      acc_to_a<E>(pa[kc], s, kc);
      acc_to_a<E>(dsa[kc], dp, kc);
    }
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) mma_m64n64k16_rs<1, E>(dv_acc, pa[kc], desc_mnmajor(sm.b[st], kc), 1);
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) mma_m64n64k16_rs<1, E>(dk_acc, dsa[kc], desc_mnmajor(sm.a[st], kc), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    fence_regs(pa);
    fence_regs(dsa);
    if (lane == 0) mbar_arrive(&sm.empty[st]);
  }
  store_rows(p.dk + b * p.dk_sb + h * p.dk_sh, p.dk_ss, key0, p.Skv, dk_acc, out_scale, out_scale, t);
  store_rows(p.dv + b * p.dv_sb + h * p.dv_sh, p.dv_ss, key0, p.Skv, dv_acc, 1.f, 1.f, t);
}

template <typename E>
__global__ void __launch_bounds__(kThreads, 1) flash_bwd_dkv_kernel(const __grid_constant__ Params<E> p) {
  extern __shared__ uint8_t smem_raw[];
  Smem<E>& sm = *reinterpret_cast<Smem<E>*>(align_1024(smem_raw));
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);  // warp-uniform
  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y % p.H;
  init_ring(sm);
  if (wg == 0) {
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      // the block's 128 keys of K and V, once, then the q / dO ring
      const int key0 = blockIdx.x * kBR;
      mbar_arrive_expect_tx(&sm.resident, 4 * kTileBytes);
      tma_load_rows(sm.k_res, &p.k_map, &sm.resident, key0, h, b);
      tma_load_rows(sm.k_res + kBT * kD, &p.k_map, &sm.resident, key0 + kBT, h, b);
      tma_load_rows(sm.v_res, &p.v_map, &sm.resident, key0, h, b);
      tma_load_rows(sm.v_res + kBT * kD, &p.v_map, &sm.resident, key0 + kBT, h, b);
      produce<true>(p, sm, &p.q_map, &p.do_map, (p.Sq + kBT - 1) / kBT, b, h);
    }
  } else {
    setmaxnreg_inc<232>();
    dkv_consumer(p, sm, wg - 1, b, h);
  }
}

template <typename E>
int configure() {
  static bool done = false;
  if (done) return 0;
  cudaError_t err =
      cudaFuncSetAttribute(flash_bwd_dq_kernel<E>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<E>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  done = true;
  return 0;
}

// The parts to launch, a bit mask (the wrapper launches all three; the
// smoke times them one at a time).
constexpr int kPartPrepass = 1, kPartDq = 2, kPartDkv = 4;

template <typename E>
int backward(
    const void* q, const void* k, const void* v, const void* o, const void* dout, const void* lse,
    const void* ds_exp, void* lse2_ws, void* delta_ws, void* dq, void* dk, void* dv,
    int batch, int heads, int sq, int skv,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    long long do_sb, long long do_ss, long long do_sh,
    long long dq_sb, long long dq_ss, long long dq_sh,
    long long dk_sb, long long dk_ss, long long dk_sh,
    long long dv_sb, long long dv_ss, long long dv_sh,
    float scale, int parts, void* stream) {
  int err = configure<E>();
  if (err != 0) return err;
  Params<E> p;
  if ((err = make_bshd_map<E>(&p.k_map, k, batch, skv, heads, k_sb, k_ss, k_sh, kBT)) != 0) return err;
  if ((err = make_bshd_map<E>(&p.v_map, v, batch, skv, heads, v_sb, v_ss, v_sh, kBT)) != 0) return err;
  if ((err = make_bshd_map<E>(&p.q_map, q, batch, sq, heads, q_sb, q_ss, q_sh, kBT)) != 0) return err;
  if ((err = make_bshd_map<E>(&p.do_map, dout, batch, sq, heads, do_sb, do_ss, do_sh, kBT)) != 0) return err;
  p.q = static_cast<const E*>(q);
  p.k = static_cast<const E*>(k);
  p.v = static_cast<const E*>(v);
  p.o = static_cast<const E*>(o);
  p.dout = static_cast<const E*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.ds_exp = static_cast<const int*>(ds_exp);
  p.lse2_ws = static_cast<float*>(lse2_ws);
  p.delta_ws = static_cast<float*>(delta_ws);
  p.dq = static_cast<E*>(dq);
  p.dk = static_cast<E*>(dk);
  p.dv = static_cast<E*>(dv);
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.o_sb = o_sb; p.o_ss = o_ss; p.o_sh = o_sh;
  p.do_sb = do_sb; p.do_ss = do_ss; p.do_sh = do_sh;
  p.dq_sb = dq_sb; p.dq_ss = dq_ss; p.dq_sh = dq_sh;
  p.dk_sb = dk_sb; p.dk_ss = dk_ss; p.dk_sh = dk_sh;
  p.dv_sb = dv_sb; p.dv_ss = dv_ss; p.dv_sh = dv_sh;
  p.B = batch;
  p.H = heads;
  p.Sq = sq;
  p.Skv = skv;
  p.Sq_pad = (sq + kBT - 1) / kBT * kBT;
  p.scale = scale;
  p.scale_log2 = scale * kLog2e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (parts & kPartPrepass) {
    const long long rows = (long long)batch * heads * p.Sq_pad;
    const int per_block = kPrepassThreads / 8;
    flash_bwd_prepass_kernel<E><<<unsigned((rows + per_block - 1) / per_block), kPrepassThreads, 0, s>>>(p);
    if ((err = static_cast<int>(cudaGetLastError())) != 0) return err;
  }
  if (parts & kPartDq) {
    flash_bwd_dq_kernel<E><<<dim3((sq + kBR - 1) / kBR, batch * heads), kThreads, kSmemBytes, s>>>(p);
    if ((err = static_cast<int>(cudaGetLastError())) != 0) return err;
  }
  if (parts & kPartDkv) {
    flash_bwd_dkv_kernel<E><<<dim3((skv + kBR - 1) / kBR, batch * heads), kThreads, kSmemBytes, s>>>(p);
    if ((err = static_cast<int>(cudaGetLastError())) != 0) return err;
  }
  return 0;
}

}  // namespace

// Dynamic shared memory a block of the dq or dkv kernel asks for, in bytes.
extern "C" int s2v_flash_attention_bwd_smem_bytes() { return kSmemBytes; }

// lse2_ws and delta_ws: fp32 [B*H, Sq_pad] workspaces, Sq_pad = ceil(Sq / 64) * 64; q, k, v, o,
// dO, dq, dk and dv bf16; ds_exp is not read (may be null).
extern "C" int s2v_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o, const void* dout, const void* lse,
    const void* ds_exp, void* lse2_ws, void* delta_ws, void* dq, void* dk, void* dv,
    int batch, int heads, int sq, int skv,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    long long do_sb, long long do_ss, long long do_sh,
    long long dq_sb, long long dq_ss, long long dq_sh,
    long long dk_sb, long long dk_ss, long long dk_sh,
    long long dv_sb, long long dv_ss, long long dv_sh,
    float scale, int parts, void* stream) {
  return backward<__nv_bfloat16>(
      q, k, v, o, dout, lse, ds_exp, lse2_ws, delta_ws, dq, dk, dv, batch, heads, sq, skv, q_sb, q_ss, q_sh, k_sb, k_ss,
      k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh, do_sb, do_ss, do_sh, dq_sb, dq_ss, dq_sh, dk_sb, dk_ss, dk_sh,
      dv_sb, dv_ss, dv_sh, scale, parts, stream);
}

// The same with q, k, v, o, dO, dq, dk and dv in fp16, and ds_exp a device int: dS is scaled by
// 2^ds_exp before its fp16 rounding, dq and dk by 2^-ds_exp after.
extern "C" int s2v_flash_attention_bwd_f16(
    const void* q, const void* k, const void* v, const void* o, const void* dout, const void* lse,
    const void* ds_exp, void* lse2_ws, void* delta_ws, void* dq, void* dk, void* dv,
    int batch, int heads, int sq, int skv,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    long long do_sb, long long do_ss, long long do_sh,
    long long dq_sb, long long dq_ss, long long dq_sh,
    long long dk_sb, long long dk_ss, long long dk_sh,
    long long dv_sb, long long dv_ss, long long dv_sh,
    float scale, int parts, void* stream) {
  return backward<__half>(
      q, k, v, o, dout, lse, ds_exp, lse2_ws, delta_ws, dq, dk, dv, batch, heads, sq, skv, q_sb, q_ss, q_sh, k_sb, k_ss,
      k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh, do_sb, do_ss, do_sh, dq_sb, dq_ss, dq_sh, dk_sb, dk_ss, dk_sh,
      dv_sb, dv_ss, dv_sh, scale, parts, stream);
}
