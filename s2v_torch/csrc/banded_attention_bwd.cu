// Banded (sliding temporal window) flash attention backward for Hopper
// (sm_90a), bf16 or fp16 in, fp32 math: the gradients that the video queries of
// windowed attention send back.
//
// Replaces the banded kernels of the TPU kernel B5,
// s2v_tpu/ops/pallas/banded_attention_bwd.py::banded_flash_attention_bwd: the
// banded dq (_dq_kernel on the band), the inverse band (_dkv_banded_kernel,
// video keys <- video queries) and the global keys' sweep (_dkv_kernel,
// global keys <- video queries).  The global queries' part goes to kernel B2
// in the wrapper, which adds the two parts of dk and dv.
//
// And those of kernel B7, ::banded_flash_attention_local_bwd (_dq_kernel_sp,
// _dkv_banded_kernel_sp and the global-key sweep over the local frames): the
// same gradients for one sequence-parallel shard of video-query frames, q, o,
// dO and lse of its own length [B, F_loc*tpf, ...] at global frames
// frame_offset + fl, against the full K/V.  dq has the local length; dk and dv
// are the full-extent partials [B, S, H, d] from the local queries only (the
// wrapper sums them over the ranks).  Frames at or past F (ring-padding dummy
// frames) are absent: their dq rows are written as zero and the dk/dv walks
// stop at the last real frame, so they contribute exactly nothing.  One kernel
// set serves B5 and B7: the query frames start at row q_row0 of q/o/dO/dq (G
// for B5, 0 for B7) and at global frame frame_offset (0 for B5).
//
// The band and its inverse are band.cuh's.  Given q, k, v, o, dO and the
// forward's natural-log lse, with D = rowsum(dO * o), it recomputes
// P = exp(scale * q k^T - lse) per tile and
//   dV = P^T dO,   dS = P * (dO v^T - D),   dQ = scale * dS k,   dK = scale * dS^T q
// over the band only.  q/k/v/o/dO are read in their [B, S, H, d] layout
// through strides and TMA maps; every range (a frame's query rows, the key
// ranges of a query frame, the query rows of a key tile) is contiguous, and
// its ragged end is a predicate (P = 0), not the TPU's frame padding, -1e30
// column and +inf lse.
//
// Bound on an H100 SXM at the training shape (B=1, H=48, G=1,576, tpf=1,350,
// F=13, w=2, d=64): 17,550 video queries x 8,326 keys each, 10*B*H*d*pairs =
// 4.49e12 operations for the five products, 4.54 ms at the 989 TFLOP/s bf16
// peak, against ~0.2 GB of traffic: compute-bound.  B7 at world size 1 does
// the same work; a shard of a P-rank ring its real frames' share (~1/P).
//
// Design: kernel B2's three kernels (flash_attention_bwd.cu, on hopper.cuh) on
// the band, on one stream:
//   * prepass - D = rowsum(dO * o) in fp32 and lse * log2(e) for the call's
//               query rows, into a [B*H, ws_rows] workspace (rows past the
//               call's hold 0; ws_rows leaves room for a tile's 16-byte-aligned
//               copy past the last row);
//   * dq      - one block per (128-query tile inside one frame, b*h): q and dO
//               stay in registers (rows past the frame's end read as zeros),
//               K and V stream in 64-key tiles over the global range, then
//               the window (band::key_walk, as kernel B4); per tile S, dP, P,
//               dS and dq += dS K;
//   * dkv     - one block per (128-key tile, b*h); a key tile never crosses
//               the global/video boundary or a frame boundary; K and V stay in
//               shared memory (SS products); q, dO and their lse/D rows stream
//               in 64-row tiles over the tile's query rows: every video query
//               row of the call for a global key tile, the rows of query frames
//               f_lo(fk) .. f_hi(fk) for a key tile of frame fk.  Per tile
//               S^T, dP^T, P^T, dS^T, dV += P^T dO, dK += dS^T q.
//   Every output is written by exactly one block: no atomics, the same bits
//   on every run.  q k^T and dO v^T are computed in both main kernels (7
//   products for the bound's 5).  Both main kernels: 3 warpgroups, warpgroup
//   0 the TMA producer (a ring of kStages stages behind full/empty mbarriers,
//   setmaxnreg gives its registers away), warpgroups 1 and 2 each own 64
//   resident rows; every product is wgmma m64n64k16, read K-major for
//   q.k^T-like products and MN-major (transposed) for the sums over rows.
// What differs from B2, and is handled here:
//   * the ragged ends of ranges inside the tensor: a 64-key tile of the dq walk
//     that runs past its range's end brings the next range's keys (P = 0 past
//     kend, at most two tiles a block); the dkv walk's last tile brings rows of
//     the next frame (or dummy frames, or zeros past the tensor): P = dS = 0
//     past q_hi, by selection, so junk there (even inf) changes nothing;
//   * a query tile ends at its frame: dq rows past it are neither computed
//     from (their q and dO read as zeros) nor written;
//   * lse/D tiles start at any row: the producer copies the 68 floats from the
//     16-byte boundary at or before the tile's first row (a bulk copy needs
//     16-byte-aligned ends), and the consumers index from the offset;
//   * load balance: a global key tile's block walks every video query row
//     (275 tiles of 64 at the training shape), a video key tile's 3-7 frames
//     (64-148 tiles): the dkv grid is 1-D with the global key tiles of every
//     (b, h) at the lowest block indices, so they start first rather than
//     form the tail.
//
// Element type (E template parameter, hopper.cuh): bf16 (the 5b models) or fp16
// (the 2b family; entries s2v_banded_attention_bwd_f16 and
// s2v_banded_attention_local_bwd_f16), kernel B2's templating: the same tiles,
// .f16 wgmma forms, P and dS rounded to fp16 before their products.  fp16 has
// no normal values below 2^-14 and flushes below 2^-25, and dS takes dO's
// scale, which a training step with no loss scaler puts near 1e-7: as in B2,
// the fp16 kernels multiply dS by 2^ds_exp before its rounding and dq, dk by
// 2^-ds_exp after (both exact), ds_exp a device int the wrapper computes
// (|dS| <= 2 max|dO_i| max|v_j| under 2^14).  The bf16 instantiation is the
// kernel as it was before fp16 came; its entries ignore ds_exp.

#include "band.cuh"
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
constexpr int kRowSpan = kBT + 4;  // lse/D floats a tile's copy brings (272 bytes)
constexpr float kLog2e = 1.4426950408889634f;

template <typename E>
struct Smem {
  E a[kStages][kBT * kD];  // K (dq kernel) or q (dkv kernel); 8 KB each
  E b[kStages][kBT * kD];  // V (dq kernel) or dO (dkv kernel)
  E k_res[kBR * kD];       // dkv kernel: the block's resident K and V (16 KB each)
  E v_res[kBR * kD];
  float lse2[kStages][kRowSpan];       // dkv kernel: the tile's lse * log2(e), from its aligned start
  float delta[kStages][kRowSpan];      // dkv kernel: the tile's D
  uint64_t full[kStages];
  uint64_t empty[kStages];
  uint64_t resident;                   // dkv kernel: K and V have arrived
};
constexpr int kSmemBytes = sizeof(Smem<__nv_bfloat16>) + 1024;
static_assert(sizeof(Smem<__half>) == sizeof(Smem<__nv_bfloat16>), "one layout for both types");

template <typename E>
struct Params {
  CUtensorMap k_map, v_map;   // box (64, kBT), over S
  CUtensorMap q_map, do_map;  // box (64, kBT), over the q tensor's q_len rows
  const E* q;
  const E* o;
  const E* dout;
  const float* lse;  // [B, H, stat_rows], natural log
  const int* ds_exp; // fp16: dS is scaled by 2^ds_exp before its rounding (null for bf16)
  float* lse2_ws;    // [B*H, ws_rows]: lse * log2(e) of query row q_row0 + i at i
  float* delta_ws;   // [B*H, ws_rows]: rowsum(dO * o)
  E* dq;
  E* dk;
  E* dv;
  long long q_sb, q_ss, q_sh;
  long long o_sb, o_ss, o_sh;
  long long do_sb, do_ss, do_sh;
  long long dq_sb, dq_ss, dq_sh;
  long long dk_sb, dk_ss, dk_sh;
  long long dv_sb, dv_ss, dv_sh;
  int B, H, G, tpf, n_frames, span, window;
  int q_row0;        // row of q/o/dO/dq/lse holding the first query frame's first token
  int frame_offset;  // global frame of the first query frame
  int q_frames;      // query frames of the call (the clip, or a shard with its dummy frames)
  int stat_rows;     // rows of a (b, h) slice of lse
  int ws_rows;       // rows of a (b, h) slice of the workspace
  int q_tiles;       // 128-query tiles per frame (dq kernel)
  int k_tiles;       // 128-key tiles per frame (dkv kernel)
  int glob_tiles;    // 128-key tiles of the global range (dkv kernel)
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

__device__ __forceinline__ void zero(float (&acc)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
}

// ------------------------------------------------------------------ prepass

// One row of 64 per 8 threads (16 bytes each); rows in [b*h][ws_rows] order.
constexpr int kPrepassThreads = 256;

template <typename E>
__global__ void __launch_bounds__(kPrepassThreads) banded_bwd_prepass_kernel(const __grid_constant__ Params<E> p) {
  const long long idx = (long long)blockIdx.x * (kPrepassThreads / 8) + (threadIdx.x >> 3);
  const int part = threadIdx.x & 7;
  const bool in_range = idx < (long long)p.B * p.H * p.ws_rows;  // every lane reaches the shuffles
  const int bh = int(idx / p.ws_rows);
  const int i = int(idx % p.ws_rows);
  const bool real = in_range && i < p.q_frames * p.tpf;
  const int row = p.q_row0 + i;
  const int b = bh / p.H;
  const int h = bh % p.H;
  float acc = 0.f;
  if (real) {
    const uint4 ov = *reinterpret_cast<const uint4*>(p.o + b * p.o_sb + row * p.o_ss + h * p.o_sh + part * 8);
    const uint4 gv =
        *reinterpret_cast<const uint4*>(p.dout + b * p.do_sb + row * p.do_ss + h * p.do_sh + part * 8);
    const uint32_t* o2 = reinterpret_cast<const uint32_t*>(&ov);
    const uint32_t* g2 = reinterpret_cast<const uint32_t*>(&gv);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 of = unpack_x2<E>(o2[e]);
      const float2 gf = unpack_x2<E>(g2[e]);
      acc = fmaf(of.x, gf.x, acc);
      acc = fmaf(of.y, gf.y, acc);
    }
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  acc += __shfl_xor_sync(0xffffffffu, acc, 2);
  acc += __shfl_xor_sync(0xffffffffu, acc, 4);
  if (in_range && part == 0) {
    p.delta_ws[idx] = acc;
    p.lse2_ws[idx] = real ? p.lse[(long long)bh * p.stat_rows + row] * kLog2e : 0.f;
  }
}

// ------------------------------------------------------------ shared parts

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

// --------------------------------------------------------------- dq kernel

template <typename E>
__device__ __forceinline__ void dq_consumer(const Params<E>& p, Smem<E>& sm, const band::KeyWalk& walk, int b,
                                            int h, int row0, int row_end) {
  const int lane = threadIdx.x & 31;
  const int t = lane & 3;
  uint32_t qa[4][4], da[4][4];
  load_a_rows(qa, p.q + b * p.q_sb + h * p.q_sh, p.q_ss, row0, row_end, t);
  load_a_rows(da, p.dout + b * p.do_sb + h * p.do_sh, p.do_ss, row0, row_end, t);
  const long long ws_row = ((long long)b * p.H + h) * p.ws_rows - p.q_row0;  // + row
  // rows past the frame: P = 0, so they add nothing (and are not written)
  const float lse0 = row0 < row_end ? p.lse2_ws[ws_row + row0] : pos_inf();
  const float lse1 = row0 + 8 < row_end ? p.lse2_ws[ws_row + row0 + 8] : pos_inf();
  const float d0 = row0 < row_end ? p.delta_ws[ws_row + row0] : 0.f;
  const float d1 = row0 + 8 < row_end ? p.delta_ws[ws_row + row0 + 8] : 0.f;
  const float c = p.scale_log2;
  float ds_up, out_scale;
  ds_scales(p, ds_up, out_scale);

  float dq_acc[32];
  zero(dq_acc);
  float s[32], dp[32];
  for (int j = 0; j < walk.n_tiles; ++j) {
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

    // keys past the end of the tile's range (the next range's, or zeros) get P = 0
    int kbase, kend;
    band::tile_keys<kBT>(walk, j, kbase, kend);
    const bool ragged = kbase + kBT > kend;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const bool hi = (i & 2) != 0;
      float pv = fast_exp2(fmaf(s[i], c, hi ? -lse1 : -lse0));
      if (ragged && kbase + (i >> 2) * 8 + t * 2 + (i & 1) >= kend) pv = 0.f;
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
  store_rows(p.dq + b * p.dq_sb + h * p.dq_sh, p.dq_ss, row0, row_end, dq_acc, out_scale, out_scale, t);
}

template <typename E>
__global__ void __launch_bounds__(kThreads, 1) banded_bwd_dq_kernel(const __grid_constant__ Params<E> p) {
  extern __shared__ uint8_t smem_raw[];
  Smem<E>& sm = *reinterpret_cast<Smem<E>*>(align_1024(smem_raw));
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);  // warp-uniform
  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y % p.H;
  const int fl = blockIdx.x / p.q_tiles;  // query frame in the call
  const int f = p.frame_offset + fl;      // ... and in the clip
  const int frame0 = p.q_row0 + fl * p.tpf;
  const int row_end = frame0 + p.tpf;
  // this thread's rows (consumers): row0 and row0 + 8
  const int row0 = frame0 + (blockIdx.x % p.q_tiles) * kBR + (wg - 1) * kRowsPerWg + ((threadIdx.x & 127) >> 5) * 16 +
                   ((threadIdx.x & 31) >> 2);
  if (f >= p.n_frames) {  // a dummy frame (block-uniform): no gradient, no loads
    if (wg > 0) {
      float zeros[32];
      zero(zeros);
      store_rows(p.dq + b * p.dq_sb + h * p.dq_sh, p.dq_ss, row0, row_end, zeros, 0.f, 0.f, threadIdx.x & 3);
    }
    return;
  }
  const band::KeyWalk walk =
      band::key_walk<kBT>(p.G, p.tpf, band::window_start(f, p.window, p.n_frames, p.span), p.span);
  init_ring<E>(sm);
  if (wg == 0) {
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      prefetch_tensor_map(&p.k_map);
      prefetch_tensor_map(&p.v_map);
      for (int j = 0; j < walk.n_tiles; ++j) {
        const int st = j % kStages;
        int kbase, kend;
        band::tile_keys<kBT>(walk, j, kbase, kend);
        mbar_wait(&sm.empty[st], ((j / kStages) & 1) ^ 1);  // the first round passes at once
        mbar_arrive_expect_tx(&sm.full[st], 2 * kTileBytes);
        tma_load_rows(sm.a[st], &p.k_map, &sm.full[st], kbase, h, b);
        tma_load_rows(sm.b[st], &p.v_map, &sm.full[st], kbase, h, b);
      }
    }
  } else {
    setmaxnreg_inc<232>();
    dq_consumer<E>(p, sm, walk, b, h, row0, row_end);
  }
}

// -------------------------------------------------------------- dkv kernel

// A dkv block's key tile and its query rows [q_lo, q_hi) of q/dO.
struct KeyTile {
  int bh;
  int tile0;    // first key of the tile
  int key_end;  // end of its range (G, or its frame's end)
  int q_lo, q_hi;
};

// Blocks [0, glob_tiles * B*H) own global key tiles, the rest tiles of one
// key frame each.
template <typename E>
__device__ __forceinline__ KeyTile key_tile_of(const Params<E>& p) {
  KeyTile kt;
  const int glob_blocks = p.glob_tiles * p.B * p.H;
  const int idx = blockIdx.x;
  const int off = p.frame_offset;
  if (idx < glob_blocks) {
    kt.bh = idx / p.glob_tiles;
    kt.tile0 = (idx % p.glob_tiles) * kBR;
    kt.key_end = p.G;
    // every real query frame of the call
    const int real = max(0, min(p.q_frames, p.n_frames - off));
    kt.q_lo = p.q_row0;
    kt.q_hi = p.q_row0 + real * p.tpf;
  } else {
    const int per_bh = p.n_frames * p.k_tiles;
    const int i = idx - glob_blocks;
    kt.bh = i / per_bh;
    const int fk = (i % per_bh) / p.k_tiles;
    kt.tile0 = p.G + fk * p.tpf + (i % p.k_tiles) * kBR;
    kt.key_end = p.G + (fk + 1) * p.tpf;
    int f_lo, f_hi;
    band::inverse_band(fk, p.window, p.n_frames, p.span, f_lo, f_hi);
    // the inverse band's frames that the call holds (f_hi < F: real frames only)
    const int lo = max(f_lo, off);
    const int hi = min(f_hi, off + p.q_frames - 1);
    kt.q_lo = p.q_row0 + (lo - off) * p.tpf;
    kt.q_hi = hi >= lo ? p.q_row0 + (hi - off + 1) * p.tpf : kt.q_lo;
  }
  return kt;
}

template <typename E>
__device__ __forceinline__ void dkv_consumer(const Params<E>& p, Smem<E>& sm, const KeyTile& kt, int wg) {
  const int tid = threadIdx.x & 127;
  const int lane = tid & 31;
  const int t = lane & 3;
  const int key0 = kt.tile0 + wg * kRowsPerWg + (tid >> 5) * 16 + (lane >> 2);  // and key0 + 8
  const int b = kt.bh / p.H;
  const int h = kt.bh % p.H;

  // this warpgroup's 64 resident keys (rows past its range are computed, not written)
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
  const int n_tiles = (kt.q_hi - kt.q_lo + kBT - 1) / kBT;
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

    // columns are queries: their lse and D came with the tile, from its aligned start;
    // queries past q_hi (the next frame's, dummy frames', zeros) get P = dS = 0
    const int qbase = kt.q_lo + j * kBT;
    const int lead = (qbase - p.q_row0) & 3;
    const bool ragged = qbase + kBT > kt.q_hi;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int col = (i >> 2) * 8 + t * 2 + (i & 1);
      const float pv = fast_exp2(fmaf(s[i], c, -sm.lse2[st][lead + col]));  // P^T
      float ds = pv * (dp[i] - sm.delta[st][lead + col]);                   // dS^T
      if constexpr (is_f16<E>()) ds *= ds_up;
      const bool keep = !ragged || qbase + col < kt.q_hi;
      s[i] = keep ? pv : 0.f;
      dp[i] = keep ? ds : 0.f;
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
  store_rows(p.dk + b * p.dk_sb + h * p.dk_sh, p.dk_ss, key0, kt.key_end, dk_acc, out_scale, out_scale, t);
  store_rows(p.dv + b * p.dv_sb + h * p.dv_sh, p.dv_ss, key0, kt.key_end, dv_acc, 1.f, 1.f, t);
}

template <typename E>
__global__ void __launch_bounds__(kThreads, 1) banded_bwd_dkv_kernel(const __grid_constant__ Params<E> p) {
  extern __shared__ uint8_t smem_raw[];
  Smem<E>& sm = *reinterpret_cast<Smem<E>*>(align_1024(smem_raw));
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);  // warp-uniform
  const KeyTile kt = key_tile_of(p);
  init_ring<E>(sm);
  if (wg == 0) {
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      const int b = kt.bh / p.H;
      const int h = kt.bh % p.H;
      prefetch_tensor_map(&p.q_map);
      prefetch_tensor_map(&p.do_map);
      // the block's 128 keys of K and V, once, then the q / dO ring
      mbar_arrive_expect_tx(&sm.resident, 4 * kTileBytes);
      tma_load_rows(sm.k_res, &p.k_map, &sm.resident, kt.tile0, h, b);
      tma_load_rows(sm.k_res + kBT * kD, &p.k_map, &sm.resident, kt.tile0 + kBT, h, b);
      tma_load_rows(sm.v_res, &p.v_map, &sm.resident, kt.tile0, h, b);
      tma_load_rows(sm.v_res + kBT * kD, &p.v_map, &sm.resident, kt.tile0 + kBT, h, b);
      const float* lse2_row = p.lse2_ws + (long long)kt.bh * p.ws_rows;
      const float* delta_row = p.delta_ws + (long long)kt.bh * p.ws_rows;
      const int n_tiles = (kt.q_hi - kt.q_lo + kBT - 1) / kBT;
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % kStages;
        const int qbase = kt.q_lo + j * kBT;
        const int aligned = (qbase - p.q_row0) & ~3;
        mbar_wait(&sm.empty[st], ((j / kStages) & 1) ^ 1);  // the first round passes at once
        mbar_arrive_expect_tx(&sm.full[st], 2 * kTileBytes + 2 * kRowSpan * 4);
        tma_load_rows(sm.a[st], &p.q_map, &sm.full[st], qbase, h, b);
        tma_load_rows(sm.b[st], &p.do_map, &sm.full[st], qbase, h, b);
        bulk_load(sm.lse2[st], lse2_row + aligned, kRowSpan * 4, &sm.full[st]);
        bulk_load(sm.delta[st], delta_row + aligned, kRowSpan * 4, &sm.full[st]);
      }
    }
  } else {
    setmaxnreg_inc<232>();
    dkv_consumer<E>(p, sm, kt, wg - 1);
  }
}

template <typename E>
int configure() {
  static bool done = false;
  if (done) return 0;
  cudaError_t err =
      cudaFuncSetAttribute(banded_bwd_dq_kernel<E>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(banded_bwd_dkv_kernel<E>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  done = true;
  return 0;
}

// The parts to launch, a bit mask (the wrappers launch all three; the smoke
// times them one at a time).
constexpr int kPartPrepass = 1, kPartDq = 2, kPartDkv = 4;

// shared by the two entry points: query frames [0, q_frames) at rows q_row0 +
// fl*tpf of q/o/dO/dq, which have q_len rows; st holds the strides of q, k, v,
// o, dO, dq, dk, dv
template <typename E>
int launch(const void* q, const void* k, const void* v, const void* o, const void* dout, const void* lse,
           const void* ds_exp, void* lse2_ws, void* delta_ws, int ws_rows, void* dq, void* dk, void* dv, int batch, int heads,
           int q_len, int global_len, int tokens_per_frame, int n_frames, int span, int window, int q_row0,
           int frame_offset, int q_frames, int stat_rows, const long long* st, float scale, int parts,
           void* stream) {
  // the workspace holds every query row of the call and a tile's aligned copy past the last
  if (ws_rows % 4 != 0 || ws_rows < q_frames * tokens_per_frame + kRowSpan) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int err = configure<E>();
  if (err != 0) return err;
  const int seq = global_len + n_frames * tokens_per_frame;
  Params<E> p;
  if ((err = make_bshd_map<E>(&p.q_map, q, batch, q_len, heads, st[0], st[1], st[2], kBT)) != 0) return err;
  if ((err = make_bshd_map<E>(&p.k_map, k, batch, seq, heads, st[3], st[4], st[5], kBT)) != 0) return err;
  if ((err = make_bshd_map<E>(&p.v_map, v, batch, seq, heads, st[6], st[7], st[8], kBT)) != 0) return err;
  if ((err = make_bshd_map<E>(&p.do_map, dout, batch, q_len, heads, st[12], st[13], st[14], kBT)) != 0) return err;
  p.q = static_cast<const E*>(q);
  p.o = static_cast<const E*>(o);
  p.dout = static_cast<const E*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.ds_exp = static_cast<const int*>(ds_exp);
  p.lse2_ws = static_cast<float*>(lse2_ws);
  p.delta_ws = static_cast<float*>(delta_ws);
  p.dq = static_cast<E*>(dq);
  p.dk = static_cast<E*>(dk);
  p.dv = static_cast<E*>(dv);
  p.q_sb = st[0]; p.q_ss = st[1]; p.q_sh = st[2];
  p.o_sb = st[9]; p.o_ss = st[10]; p.o_sh = st[11];
  p.do_sb = st[12]; p.do_ss = st[13]; p.do_sh = st[14];
  p.dq_sb = st[15]; p.dq_ss = st[16]; p.dq_sh = st[17];
  p.dk_sb = st[18]; p.dk_ss = st[19]; p.dk_sh = st[20];
  p.dv_sb = st[21]; p.dv_ss = st[22]; p.dv_sh = st[23];
  p.B = batch;
  p.H = heads;
  p.G = global_len;
  p.tpf = tokens_per_frame;
  p.n_frames = n_frames;
  p.span = span;
  p.window = window;
  p.q_row0 = q_row0;
  p.frame_offset = frame_offset;
  p.q_frames = q_frames;
  p.stat_rows = stat_rows;
  p.ws_rows = ws_rows;
  p.q_tiles = (tokens_per_frame + kBR - 1) / kBR;
  p.k_tiles = p.q_tiles;
  p.glob_tiles = (global_len + kBR - 1) / kBR;
  p.scale = scale;
  p.scale_log2 = scale * kLog2e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (parts & kPartPrepass) {
    const long long rows = (long long)batch * heads * ws_rows;
    const int per_block = kPrepassThreads / 8;
    banded_bwd_prepass_kernel<E><<<unsigned((rows + per_block - 1) / per_block), kPrepassThreads, 0, s>>>(p);
    if ((err = static_cast<int>(cudaGetLastError())) != 0) return err;
  }
  if (parts & kPartDq) {
    banded_bwd_dq_kernel<E><<<dim3(q_frames * p.q_tiles, batch * heads), kThreads, kSmemBytes, s>>>(p);
    if ((err = static_cast<int>(cudaGetLastError())) != 0) return err;
  }
  if (parts & kPartDkv) {
    const unsigned blocks = unsigned((p.glob_tiles + n_frames * p.k_tiles) * batch * heads);
    banded_bwd_dkv_kernel<E><<<blocks, kThreads, kSmemBytes, s>>>(p);
    if ((err = static_cast<int>(cudaGetLastError())) != 0) return err;
  }
  return 0;
}

template <typename E>
int backward(const void* q, const void* k, const void* v, const void* o, const void* dout, const void* lse,
             const void* ds_exp, void* lse2_ws, void* delta_ws, int ws_rows, void* dq, void* dk, void* dv, int batch,
             int heads, int seq, int global_len, int tokens_per_frame, int n_frames, int span, int window,
             const long long* st, float scale, int parts, void* stream) {
  return launch<E>(q, k, v, o, dout, lse, ds_exp, lse2_ws, delta_ws, ws_rows, dq, dk, dv, batch, heads, seq,
                   global_len, tokens_per_frame, n_frames, span, window, global_len, 0, n_frames, seq, st, scale,
                   parts, stream);
}

template <typename E>
int backward_local(const void* q, const void* k, const void* v, const void* o, const void* dout, const void* lse,
                   const void* ds_exp, void* lse2_ws, void* delta_ws, int ws_rows, void* dq, void* dk, void* dv,
                   int batch, int heads, int global_len, int tokens_per_frame, int n_frames, int span, int window,
                   int frame_offset, int local_frames, const long long* st, float scale, int parts, void* stream) {
  const int q_len = local_frames * tokens_per_frame;
  return launch<E>(q, k, v, o, dout, lse, ds_exp, lse2_ws, delta_ws, ws_rows, dq, dk, dv, batch, heads, q_len,
                   global_len, tokens_per_frame, n_frames, span, window, 0, frame_offset, local_frames, q_len, st,
                   scale, parts, stream);
}

}  // namespace

// Dynamic shared memory a block of the dq or dkv kernel asks for, in bytes.
extern "C" int s2v_banded_attention_bwd_smem_bytes() { return kSmemBytes; }

#define S2V_BANDED_BWD_POINTERS                                                                            \
  const void *q, const void *k, const void *v, const void *o, const void *dout, const void *lse,        \
      const void *ds_exp, void *lse2_ws, void *delta_ws, int ws_rows, void *dq, void *dk, void *dv
#define S2V_BANDED_BWD_STRIDES                                                                             \
  long long q_sb, long long q_ss, long long q_sh, long long k_sb, long long k_ss, long long k_sh,          \
      long long v_sb, long long v_ss, long long v_sh, long long o_sb, long long o_ss, long long o_sh,     \
      long long do_sb, long long do_ss, long long do_sh, long long dq_sb, long long dq_ss, long long dq_sh, \
      long long dk_sb, long long dk_ss, long long dk_sh, long long dv_sb, long long dv_ss, long long dv_sh
#define S2V_BANDED_BWD_STRIDE_ARRAY                                                                        \
  {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh,                                 \
   do_sb, do_ss, do_sh, dq_sb, dq_ss, dq_sh, dk_sb, dk_ss, dk_sh, dv_sb, dv_ss, dv_sh}

// B5: every tensor [B, S, H, d] in bf16, lse [B, H, S]; dq at the video rows,
// dk/dv (the video queries' part) at all.  lse2_ws and delta_ws: fp32 [B*H,
// ws_rows] workspaces, ws_rows a multiple of 4 and at least F*tpf + 68.  ds_exp
// is not read (may be null).
extern "C" int s2v_banded_attention_bwd(S2V_BANDED_BWD_POINTERS, int batch, int heads, int seq, int global_len,
                                        int tokens_per_frame, int n_frames, int span, int window,
                                        S2V_BANDED_BWD_STRIDES, float scale, int parts, void* stream) {
  const long long st[24] = S2V_BANDED_BWD_STRIDE_ARRAY;
  return backward<__nv_bfloat16>(q, k, v, o, dout, lse, ds_exp, lse2_ws, delta_ws, ws_rows, dq, dk, dv, batch,
                                 heads, seq, global_len, tokens_per_frame, n_frames, span, window, st, scale, parts,
                                 stream);
}

// The same in fp16, with ds_exp a device int: dS is scaled by 2^ds_exp before
// its fp16 rounding, dq and dk by 2^-ds_exp after.
extern "C" int s2v_banded_attention_bwd_f16(S2V_BANDED_BWD_POINTERS, int batch, int heads, int seq, int global_len,
                                            int tokens_per_frame, int n_frames, int span, int window,
                                            S2V_BANDED_BWD_STRIDES, float scale, int parts, void* stream) {
  const long long st[24] = S2V_BANDED_BWD_STRIDE_ARRAY;
  return backward<__half>(q, k, v, o, dout, lse, ds_exp, lse2_ws, delta_ws, ws_rows, dq, dk, dv, batch, heads, seq,
                          global_len, tokens_per_frame, n_frames, span, window, st, scale, parts, stream);
}

// B7: q, o, dO, dq [B, F_loc*tpf, H, d] and lse [B, H, F_loc*tpf] of the shard at
// frame_offset; k, v and the partial dk, dv the full [B, S, H, d]; all bf16; the
// workspaces as B5's, with ws_rows at least F_loc*tpf + 68
extern "C" int s2v_banded_attention_local_bwd(S2V_BANDED_BWD_POINTERS, int batch, int heads, int global_len,
                                              int tokens_per_frame, int n_frames, int span, int window,
                                              int frame_offset, int local_frames, S2V_BANDED_BWD_STRIDES,
                                              float scale, int parts, void* stream) {
  const long long st[24] = S2V_BANDED_BWD_STRIDE_ARRAY;
  return backward_local<__nv_bfloat16>(q, k, v, o, dout, lse, ds_exp, lse2_ws, delta_ws, ws_rows, dq, dk, dv, batch,
                                       heads, global_len, tokens_per_frame, n_frames, span, window, frame_offset,
                                       local_frames, st, scale, parts, stream);
}

// The same in fp16 (ds_exp as in s2v_banded_attention_bwd_f16).
extern "C" int s2v_banded_attention_local_bwd_f16(S2V_BANDED_BWD_POINTERS, int batch, int heads, int global_len,
                                                  int tokens_per_frame, int n_frames, int span, int window,
                                                  int frame_offset, int local_frames, S2V_BANDED_BWD_STRIDES,
                                                  float scale, int parts, void* stream) {
  const long long st[24] = S2V_BANDED_BWD_STRIDE_ARRAY;
  return backward_local<__half>(q, k, v, o, dout, lse, ds_exp, lse2_ws, delta_ws, ws_rows, dq, dk, dv, batch, heads,
                                global_len, tokens_per_frame, n_frames, span, window, frame_offset, local_frames, st,
                                scale, parts, stream);
}
