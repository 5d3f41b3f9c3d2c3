// fp32 attention backward for Hopper (sm_90a): kernels B2, B5 and B7 on fp32
// inputs, a pre-pass and two kernels over the forward's key ranges.
//
// Replaces, for fp32 inputs (the JAX kernels compute in the input's type):
//   B2  s2v_tpu/ops/pallas/flash_attention_bwd.py::flash_attention_bwd: every
//       query walks [0, Skv), every key [0, Sq);
//   B5  s2v_tpu/ops/pallas/banded_attention_bwd.py::banded_flash_attention_bwd
//       (the video queries' part; the global queries' part is one B2 call):
//       a query frame walks the global keys and its window, a key frame the
//       query frames of its inverse band (band.cuh), a global key every
//       video query;
//   B7  banded_attention_bwd.py::banded_flash_attention_local_bwd: B5 on one
//       frame shard at a runtime offset; dummy frames (at or past F) get a
//       zero dq and reach no dk/dv walk.
//
// With P = exp2(s*c - lse*log2 e), c = scale*log2 e, D = rowsum(dO o):
//   dV = P^T.dO,  dS = P (dO.V^T - D),  dQ = scale dS.K,  dK = scale dS^T.q
//
// Bound on an H100 SXM at the training shape (B=1, S=19,126, H=48, d=64):
// the five products 10*B*H*S^2*d = 1.12e13 operations, 22.7 ms at the 495
// TFLOP/s TF32 peak, 68 ms for three passes; the kernels compute seven (q.k^T
// and dO.v^T in both), so 3xTF32 puts their floor at 95 ms.
//
// Design: the pre-pass writes lse*log2 e and D per query row into an fp32
// workspace [2, B*H, sq], and, once per call, the planes (attention_f32.cuh)
// the kernels read: the row planes of q, dO, k and v, the transposed planes
// of k, q and dO.  Both kernels have two consumer warpgroups of 64 rows (a
// block owns 128 rows, so every streamed tile serves 128 of them), thread 0
// issuing the TMA loads, and every product on wgmma m64nNk8 tf32 in three
// passes:
//   dq:    128 query rows; q's and dO's fragments in registers; 32-key
//          tiles of K's and V's row planes and K's transposed planes (48 KB)
//          through four stages; S = q.K^T and dP = dO.V^T m64n32 with A
//          from registers, dQ += dS.K m64n64 from dS's fragments;
//   dk/dv: 128 keys; K's fragments in registers; V's row planes resident;
//          32-query tiles of q's and dO's row and transposed planes (64 KB)
//          through two stages (three would need 256 KB); P^T = K.q^T and
//          dP^T = V.dO^T m64n32, dV += P^T.dO and dK += dS^T.q m64n64.
// Each tile's product is summed from zero and added to dq, dk, dv in fp32.
// Every output is written by one block, so a launch is deterministic bit
// for bit.

#include "attention_f32.cuh"

namespace {

using namespace f32attn;

constexpr int kTile = 32;       // keys (dq) or queries (dk/dv) per streamed tile
constexpr int kDqStages = 4;
constexpr int kDkvStages = 2;
constexpr int kRowTile = kTile * kD;  // one plane of a 32 x 64 row tile, 8 KB
constexpr int kColTile = kD * kTile;  // one plane of a 64 x 32 transposed tile, 8 KB
constexpr int kResTile = kBlockRows * kD;  // one plane of the 128-row resident tile, 32 KB

struct DqSmem {
  float k[kDqStages][2][kRowTile];          // K's row planes
  float v[kDqStages][2][kRowTile];          // V's row planes
  float kt[kDqStages][2][kColTile];         // K's transposed planes
  uint64_t full[kDqStages];
  uint64_t empty[kDqStages];
};

struct DkvSmem {
  float v[2][kResTile];                     // V's row planes of the block's keys
  float q[kDkvStages][2][kRowTile];         // q's row planes
  float g[kDkvStages][2][kRowTile];         // dO's row planes
  float qt[kDkvStages][2][kColTile];        // q's transposed planes
  float gt[kDkvStages][2][kColTile];        // dO's transposed planes
  uint64_t full[kDkvStages];
  uint64_t empty[kDkvStages];
  uint64_t res_full;
};

constexpr int kDqSmem = int(sizeof(DqSmem)) + 1024;
constexpr int kDkvSmem = int(sizeof(DkvSmem)) + 1024;

struct BwdParams {
  CUtensorMap res_map;   // dk/dv: the resident tile's row planes (V), box (32, 128)
  CUtensorMap a_map;     // row planes streamed first (dq: K; dk/dv: q), box (32, 32)
  CUtensorMap b_map;     // row planes streamed second (dq: V; dk/dv: dO), box (32, 32)
  CUtensorMap at_map;    // transposed planes streamed (dq: K; dk/dv: q), box (32, 64)
  CUtensorMap bt_map;    // dk/dv: dO's transposed planes, box (32, 64)
  const float* frag_planes;  // the row planes read into registers (dq: q; dk/dv: k)
  const float* frag2_planes; // dq: dO's row planes, also read into registers
  const float* ws;           // [2, B*H, sq]: lse*log2 e, then D
  float *dq, *dk, *dv;
  int heads, bh_total, sq, skv;
  long long dq_sb, dq_ss, dq_sh, dk_sb, dk_ss, dk_sh, dv_sb, dv_ss, dv_sh;
  float scale;
  Band band;
};

// the query rows that hold a real frame (a band's shard may end in dummy frames)
__device__ __forceinline__ int real_rows(const BwdParams& p) {
  if (!p.band.banded) return p.sq;
  const int frames = max(0, min(p.band.local_frames, p.band.n_frames - p.band.frame_offset));
  return frames * p.band.tpf;
}

struct PrepassArgs {
  const float *o, *dout, *lse;
  float* ws;
  int heads, sq, lse_ld, bh_total;
  long long o_sb, o_ss, o_sh, g_sb, g_ss, g_sh;
};

// one warp per query row: lse*log2 e and D = rowsum(dO o)
__global__ void __launch_bounds__(256) prepass_kernel(const PrepassArgs a) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * 8 + warp;
  const int bh = blockIdx.y, b = bh / a.heads, h = bh % a.heads;
  if (row >= a.sq) return;
  const float2 ov = *reinterpret_cast<const float2*>(a.o + b * a.o_sb + h * a.o_sh + row * a.o_ss + 2 * lane);
  const float2 gv = *reinterpret_cast<const float2*>(a.dout + b * a.g_sb + h * a.g_sh + row * a.g_ss + 2 * lane);
  float d = ov.x * gv.x + ov.y * gv.y;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) d += __shfl_xor_sync(0xffffffffu, d, off);
  if (lane == 0) {
    const long long at = (long long)bh * a.sq + row;
    a.ws[at] = a.lse[(long long)bh * a.lse_ld + row] * kLog2e;
    a.ws[(long long)a.bh_total * a.sq + at] = d;
  }
}

// barrier setup of a block: full (one arrival plus bytes), empty (one per
// consumer warp), and the resident tile's, if there is one
template <int STAGES>
__device__ __forceinline__ void init_barriers(uint64_t (&full)[STAGES], uint64_t (&empty)[STAGES], uint64_t* res) {
  if (threadIdx.x == 0) {
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], kConsumers * 4);
    }
    if (res != nullptr) mbar_init(res, 1);
    fence_barrier_init();
  }
  __syncthreads();
}

// both row planes (dst[0] big, dst[1] small) of 128 resident rows [r0, r0 + 128) of (b, h)
__device__ __forceinline__ void load_resident(float (&dst)[2][kResTile], const CUtensorMap* map, uint64_t* bar,
                                              int r0, int bh, int bh_total) {
  mbar_arrive_expect_tx(bar, 2 * kResTile * 4);
  load_row_tile(dst[0], map, bar, r0, bh, kBlockRows);
  load_row_tile(dst[1], map, bar, r0, bh_total + bh, kBlockRows);
}

// ------------------------------------------------------------------ dq

__device__ __forceinline__ void dq_stage(const BwdParams& p, DqSmem& sm, int j, const AlignedWalk<kTile>& walk,
                                         int bh) {
  int k0, klo, kend;
  walk.tile(j, k0, klo, kend);
  const int st = j % kDqStages;
  uint64_t* bar = &sm.full[st];
  mbar_arrive_expect_tx(bar, 2 * (2 * kRowTile + kColTile) * 4);
  for (int pl = 0; pl < 2; ++pl) {
    const int plane = pl * p.bh_total + bh;
    load_row_tile(sm.k[st][pl], &p.a_map, bar, k0, plane, kTile);
    load_row_tile(sm.v[st][pl], &p.b_map, bar, k0, plane, kTile);
    load_cols_tile(sm.kt[st][pl], &p.at_map, bar, k0, plane, 1);
  }
}

__global__ void __launch_bounds__(kThreads, 1) dq_kernel(const __grid_constant__ BwdParams p) {
  extern __shared__ uint8_t smem_raw[];
  DqSmem& sm = *reinterpret_cast<DqSmem*>(align_1024(smem_raw));
  const int tid = threadIdx.x, lane = tid & 31, t = lane & 3, g = lane >> 2;
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int bh = blockIdx.y, b = bh / p.heads, h = bh % p.heads;

  int r0, r_end;
  band::KeyWalk keys;
  if (p.band.banded) {
    const int per_frame = (p.band.tpf + kBlockRows - 1) / kBlockRows;
    const int fl = blockIdx.x / per_frame;
    r0 = fl * p.band.tpf + (blockIdx.x % per_frame) * kBlockRows;
    r_end = min(r0 + kBlockRows, (fl + 1) * p.band.tpf);
    const int ws = band::window_start(p.band.frame_offset + fl, p.band.window, p.band.n_frames, p.band.span);
    keys = band::key_walk<kTile>(p.band.G, p.band.tpf, ws, p.band.span);
    if (r0 >= real_rows(p)) keys.n_tiles = keys.n_first = 0;  // a dummy frame: dq = 0
  } else {
    r0 = blockIdx.x * kBlockRows;
    r_end = min(r0 + kBlockRows, p.sq);
    keys = full_walk<kTile>(p.skv);
  }
  const AlignedWalk<kTile> walk(keys);
  const int row0 = r0 + wg * kWgRows + ((tid >> 5) & 3) * 16;
  const int valid = r_end - row0;

  init_barriers(sm.full, sm.empty, nullptr);
  if (tid == 0 && walk.n_tiles > 0) {
    prefetch_tensor_map(&p.a_map);
    prefetch_tensor_map(&p.b_map);
    prefetch_tensor_map(&p.at_map);
    for (int j = 0; j < kDqStages - 1 && j < walk.n_tiles; ++j) dq_stage(p, sm, j, walk, bh);
  }

  // q's and dO's fragments of this warp's rows, split once, in registers
  uint32_t qb[8][4], qs[8][4], gb[8][4], gs[8][4];
  {
    const long long at = ((long long)bh * p.sq + row0) * kD, small = (long long)p.bh_total * p.sq * kD;
    load_a_planes(p.frag_planes + at, p.frag_planes + small + at, valid, qb, qs);
    load_a_planes(p.frag2_planes + at, p.frag2_planes + small + at, valid, gb, gs);
  }
  // this thread's rows g and g + 8: lse*log2 e and D (rows past the end read row r0)
  float lse2[2], dd[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r < r_end ? row0 + g + 8 * r : r0;
    lse2[r] = p.ws[(long long)bh * p.sq + row];
    dd[r] = p.ws[(long long)(p.bh_total + bh) * p.sq + row];
  }
  const float c = p.scale * kLog2e;
  float dq[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dq[i] = 0.f;

  for (int j = 0; j < walk.n_tiles; ++j) {
    if (tid == 0) {
      // the producer's step: tile j + kDqStages - 1 into the stage tile j - 1
      // used, once every consumer warp is done with it (round 0 passes at once)
      const int jn = j + kDqStages - 1;
      if (jn < walk.n_tiles) {
        mbar_wait(&sm.empty[jn % kDqStages], ((jn / kDqStages) & 1) ^ 1);
        dq_stage(p, sm, jn, walk, bh);
      }
    }
    __syncwarp();
    int k0, klo, kend;
    walk.tile(j, k0, klo, kend);
    const int st = j % kDqStages;
    mbar_wait(&sm.full[st], (j / kDqStages) & 1);

    // S = q.K^T and dP = dO.V^T (A from registers): 64 rows x 32 keys
    float s[16], dp[16];
    wgmma_fence();
#pragma unroll
    for (int pass = 0; pass < 3; ++pass)
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        wgmma_tf32_rs_n32(s, pass == 0 ? qs[kk] : qb[kk], desc_k8(sm.k[st][pass == 1], kTile, kk), pass | kk);
        wgmma_tf32_rs_n32(dp, pass == 0 ? gs[kk] : gb[kk], desc_k8(sm.v[st][pass == 1], kTile, kk), pass | kk);
      }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int key = k0 + (i >> 2) * 8 + 2 * t + (i & 1);
      const int r = (i >> 1) & 1;
      const float pr = key >= klo && key < kend ? exp2f(s[i] * c - lse2[r]) : 0.f;
      s[i] = pr * (dp[i] - dd[r]);  // dS
    }
    // this tile's dS.K from zero, added in fp32 (see attention_f32.cuh)
    uint32_t db[4][4], ds[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) acc_to_a(s + 4 * kk, db[kk], ds[kk]);
    float part[32];
    wgmma_fence();
#pragma unroll
    for (int pass = 0; pass < 3; ++pass)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_tf32_rs_n64(part, pass == 0 ? ds[kk] : db[kk], desc_k8(sm.kt[st][pass == 1], kD, kk), pass | kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(part);
    fence_regs(db);
    fence_regs(ds);
    if (lane == 0) mbar_arrive(&sm.empty[st]);
#pragma unroll
    for (int i = 0; i < 32; ++i) dq[i] += part[i];
  }
  store_acc_rows(p.dq + b * p.dq_sb + h * p.dq_sh + (long long)row0 * p.dq_ss, p.dq_ss, dq, p.scale, valid);
}

// ---------------------------------------------------------------- dk/dv

__device__ __forceinline__ void dkv_stage(const BwdParams& p, DkvSmem& sm, int j, int q_base, int bh) {
  const int st = j % kDkvStages, qb0 = q_base + j * kTile;
  uint64_t* bar = &sm.full[st];
  mbar_arrive_expect_tx(bar, 2 * (2 * kRowTile + 2 * kColTile) * 4);
  for (int pl = 0; pl < 2; ++pl) {
    const int plane = pl * p.bh_total + bh;
    load_row_tile(sm.q[st][pl], &p.a_map, bar, qb0, plane, kTile);
    load_row_tile(sm.g[st][pl], &p.b_map, bar, qb0, plane, kTile);
    load_cols_tile(sm.qt[st][pl], &p.at_map, bar, qb0, plane, 1);
    load_cols_tile(sm.gt[st][pl], &p.bt_map, bar, qb0, plane, 1);
  }
}

__global__ void __launch_bounds__(kThreads, 1) dkv_kernel(const __grid_constant__ BwdParams p) {
  extern __shared__ uint8_t smem_raw[];
  DkvSmem& sm = *reinterpret_cast<DkvSmem*>(align_1024(smem_raw));
  const int tid = threadIdx.x, lane = tid & 31, t = lane & 3;
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int bh = blockIdx.y, b = bh / p.heads, h = bh % p.heads;

  // the block's keys [k0, k_end) and the query rows [q_lo, q_hi) that attend them
  int k0, k_end, q_lo, q_hi;
  if (p.band.banded) {
    const int n_glob = (p.band.G + kBlockRows - 1) / kBlockRows;
    if (blockIdx.x < n_glob) {
      k0 = blockIdx.x * kBlockRows;
      k_end = min(k0 + kBlockRows, p.band.G);
      q_lo = 0;
      q_hi = real_rows(p);
    } else {
      const int per_frame = (p.band.tpf + kBlockRows - 1) / kBlockRows;
      const int j = blockIdx.x - n_glob, fk = j / per_frame;
      k0 = p.band.G + fk * p.band.tpf + (j % per_frame) * kBlockRows;
      k_end = min(k0 + kBlockRows, p.band.G + (fk + 1) * p.band.tpf);
      int f_lo, f_hi;
      band::inverse_band(fk, p.band.window, p.band.n_frames, p.band.span, f_lo, f_hi);
      const int lo = max(f_lo, p.band.frame_offset);
      const int hi = min(f_hi, p.band.frame_offset + p.band.local_frames - 1);
      q_lo = (lo - p.band.frame_offset) * p.band.tpf;
      q_hi = hi >= lo ? (hi - p.band.frame_offset + 1) * p.band.tpf : q_lo;
    }
  } else {
    k0 = blockIdx.x * kBlockRows;
    k_end = min(k0 + kBlockRows, p.skv);
    q_lo = 0;
    q_hi = p.sq;
  }
  // query tiles from q_lo rounded down to kAlign (the transposed planes' TMA boxes); rows before q_lo get P = 0
  const int q_base = align_down(q_lo);
  const int n_tiles = q_hi > q_lo ? (q_hi - q_base + kTile - 1) / kTile : 0;
  const int row0 = k0 + wg * kWgRows + ((tid >> 5) & 3) * 16;
  const int valid = k_end - row0;

  init_barriers(sm.full, sm.empty, &sm.res_full);
  if (tid == 0 && n_tiles > 0) {
    prefetch_tensor_map(&p.res_map);
    prefetch_tensor_map(&p.a_map);
    prefetch_tensor_map(&p.b_map);
    prefetch_tensor_map(&p.at_map);
    prefetch_tensor_map(&p.bt_map);
    load_resident(sm.v, &p.res_map, &sm.res_full, k0, bh, p.bh_total);
    for (int j = 0; j < kDkvStages - 1 && j < n_tiles; ++j) dkv_stage(p, sm, j, q_base, bh);
  }

  uint32_t kb[8][4], ks[8][4];
  {
    const float* big = p.frag_planes + ((long long)bh * p.skv + row0) * kD;
    load_a_planes(big, big + (long long)p.bh_total * p.skv * kD, valid, kb, ks);
  }
  const float* ws_l = p.ws + (long long)bh * p.sq;
  const float* ws_d = p.ws + (long long)(p.bh_total + bh) * p.sq;
  const float c = p.scale * kLog2e;
  float dk[32], dv[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;
  if (n_tiles > 0) mbar_wait(&sm.res_full, 0);

  for (int j = 0; j < n_tiles; ++j) {
    if (tid == 0) {
      const int jn = j + kDkvStages - 1;
      if (jn < n_tiles) {
        mbar_wait(&sm.empty[jn % kDkvStages], ((jn / kDkvStages) & 1) ^ 1);
        dkv_stage(p, sm, jn, q_base, bh);
      }
    }
    __syncwarp();
    const int qb0 = q_base + j * kTile;
    const int st = j % kDkvStages;
    // this thread's queries' lse*log2 e and D (+inf and 0 outside the range: P = 0)
    float lq[8], dq8[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = qb0 + (i >> 1) * 8 + 2 * t + (i & 1);
      const bool ok = row >= q_lo && row < q_hi;
      lq[i] = ok ? ws_l[row] : INFINITY;
      dq8[i] = ok ? ws_d[row] : 0.f;
    }
    mbar_wait(&sm.full[st], (j / kDkvStages) & 1);

    // P^T = K.q^T (A from registers) and dP^T = V.dO^T (A from shared memory): 64 keys x 32 queries
    float pt[16], dpt[16];
    wgmma_fence();
#pragma unroll
    for (int pass = 0; pass < 3; ++pass)
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        wgmma_tf32_rs_n32(pt, pass == 0 ? ks[kk] : kb[kk], desc_k8(sm.q[st][pass == 1], kTile, kk), pass | kk);
        wgmma_tf32_ss_n32(dpt, desc_k8(sm.v[pass == 0], kBlockRows, kk, wg * kWgRows),
                          desc_k8(sm.g[st][pass == 1], kTile, kk), pass | kk);
      }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(pt);
    fence_regs(dpt);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int col = ((i >> 2) << 1) | (i & 1);  // this thread's query (0..7 of lq, dq8)
      pt[i] = exp2f(pt[i] * c - lq[col]);
      dpt[i] = pt[i] * (dpt[i] - dq8[col]);  // dS^T
    }
    // each tile's products from zero, added in fp32 (see attention_f32.cuh)
    uint32_t fb[4][4], fs[4][4];
    float part[32];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) acc_to_a(pt + 4 * kk, fb[kk], fs[kk]);
    wgmma_fence();
#pragma unroll
    for (int pass = 0; pass < 3; ++pass)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_tf32_rs_n64(part, pass == 0 ? fs[kk] : fb[kk], desc_k8(sm.gt[st][pass == 1], kD, kk), pass | kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(part);
    fence_regs(fb);
    fence_regs(fs);
#pragma unroll
    for (int i = 0; i < 32; ++i) dv[i] += part[i];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) acc_to_a(dpt + 4 * kk, fb[kk], fs[kk]);
    wgmma_fence();
#pragma unroll
    for (int pass = 0; pass < 3; ++pass)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_tf32_rs_n64(part, pass == 0 ? fs[kk] : fb[kk], desc_k8(sm.qt[st][pass == 1], kD, kk), pass | kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(part);
    fence_regs(fb);
    fence_regs(fs);
    if (lane == 0) mbar_arrive(&sm.empty[st]);
#pragma unroll
    for (int i = 0; i < 32; ++i) dk[i] += part[i];
  }
  store_acc_rows(p.dk + b * p.dk_sb + h * p.dk_sh + (long long)row0 * p.dk_ss, p.dk_ss, dk, p.scale, valid);
  store_acc_rows(p.dv + b * p.dv_sb + h * p.dv_sh + (long long)row0 * p.dv_ss, p.dv_ss, dv, 1.f, valid);
}

// the planes workspace: row planes of q, dO (sq rows), k, v (skv rows), then
// transposed planes of k, q, dO
struct Planes {
  float *q, *g, *k, *v, *kt, *qt, *gt;
  Planes(float* base, int bh, int sq, int skv) {
    q = base;
    g = q + row_planes(bh, sq);
    k = g + row_planes(bh, sq);
    v = k + row_planes(bh, skv);
    kt = v + row_planes(bh, skv);
    qt = kt + col_planes(bh, skv);
    gt = qt + col_planes(bh, sq);
  }
  static long long floats(int bh, int sq, int skv) {
    return 2 * row_planes(bh, sq) + 2 * row_planes(bh, skv) + col_planes(bh, skv) + 2 * col_planes(bh, sq);
  }
};

}  // namespace

extern "C" int s2v_attention_f32_bwd_smem_bytes() { return kDqSmem > kDkvSmem ? kDqSmem : kDkvSmem; }

// floats of the planes workspace of one backward
extern "C" long long s2v_attention_f32_bwd_planes(int batch, int heads, int sq, int skv) {
  return Planes::floats(batch * heads, sq, skv);
}

// parts: 1 the pre-pass (the workspace rows and the planes), 2 the dq
// kernel, 4 the dk/dv kernel; ws [2, B*H, sq] and planes (of
// s2v_attention_f32_bwd_planes floats) fp32 workspaces that parts 2 and 4
// read as part 1 wrote them.  Returns 0 or an error code.
extern "C" int s2v_attention_f32_bwd(
    const void* q, const void* k, const void* v, const void* o, const void* dout, const void* lse, void* ws,
    void* planes, void* dq, void* dk, void* dv, int batch, int heads, int sq, int skv,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    long long g_sb, long long g_ss, long long g_sh,
    long long dq_sb, long long dq_ss, long long dq_sh,
    long long dk_sb, long long dk_ss, long long dk_sh,
    long long dv_sb, long long dv_ss, long long dv_sh,
    int lse_ld, float scale, int parts,
    int banded, int G, int tpf, int n_frames, int span, int window, int frame_offset, int local_frames,
    void* stream) {
  const int bh = batch * heads;
  if (bh == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Planes pl(static_cast<float*>(planes), bh, sq, skv);
  int err = 0;
  if (parts & 1) {
    if (sq > 0) {
      PrepassArgs a = {static_cast<const float*>(o), static_cast<const float*>(dout), static_cast<const float*>(lse),
                       static_cast<float*>(ws), heads, sq, lse_ld, bh, o_sb, o_ss, o_sh, g_sb, g_ss, g_sh};
      prepass_kernel<<<dim3((sq + 7) / 8, bh), 256, 0, st>>>(a);
      if ((err = static_cast<int>(cudaGetLastError())) != 0) return err;
    }
    const float *fq = static_cast<const float*>(q), *fk = static_cast<const float*>(k);
    const float *fv = static_cast<const float*>(v), *fg = static_cast<const float*>(dout);
    if ((err = launch_split_rows(fq, pl.q, batch, heads, sq, q_sb, q_ss, q_sh, st)) != 0) return err;
    if ((err = launch_split_rows(fg, pl.g, batch, heads, sq, g_sb, g_ss, g_sh, st)) != 0) return err;
    if ((err = launch_split_rows(fk, pl.k, batch, heads, skv, k_sb, k_ss, k_sh, st)) != 0) return err;
    if ((err = launch_split_rows(fv, pl.v, batch, heads, skv, v_sb, v_ss, v_sh, st)) != 0) return err;
    if ((err = launch_split_cols(fk, pl.kt, batch, heads, skv, k_sb, k_ss, k_sh, st)) != 0) return err;
    if ((err = launch_split_cols(fq, pl.qt, batch, heads, sq, q_sb, q_ss, q_sh, st)) != 0) return err;
    if ((err = launch_split_cols(fg, pl.gt, batch, heads, sq, g_sb, g_ss, g_sh, st)) != 0) return err;
  }
  BwdParams p = {};
  p.ws = static_cast<const float*>(ws);
  p.dq = static_cast<float*>(dq);
  p.dk = static_cast<float*>(dk);
  p.dv = static_cast<float*>(dv);
  p.heads = heads;
  p.bh_total = bh;
  p.sq = sq;
  p.skv = skv;
  p.dq_sb = dq_sb; p.dq_ss = dq_ss; p.dq_sh = dq_sh;
  p.dk_sb = dk_sb; p.dk_ss = dk_ss; p.dk_sh = dk_sh;
  p.dv_sb = dv_sb; p.dv_ss = dv_ss; p.dv_sh = dv_sh;
  p.scale = scale;
  p.band = Band{banded, G, tpf, n_frames, span, window, frame_offset, local_frames};
  if ((parts & 2) && sq > 0) {
    const int blocks = banded ? local_frames * ((tpf + kBlockRows - 1) / kBlockRows)
                              : (sq + kBlockRows - 1) / kBlockRows;
    if ((err = make_plane_map(&p.a_map, pl.k, kD, skv, 2LL * bh, kTile)) != 0) return err;
    if ((err = make_plane_map(&p.b_map, pl.v, kD, skv, 2LL * bh, kTile)) != 0) return err;
    if ((err = make_plane_map(&p.at_map, pl.kt, pad_seq(skv), kD, 2LL * bh, kD)) != 0) return err;
    p.frag_planes = pl.q;
    p.frag2_planes = pl.g;
    if (blocks > 0) {
      cudaError_t e = cudaFuncSetAttribute(dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kDqSmem);
      if (e != cudaSuccess) return static_cast<int>(e);
      dq_kernel<<<dim3(blocks, bh), kThreads, kDqSmem, st>>>(p);
      if ((err = static_cast<int>(cudaGetLastError())) != 0) return err;
    }
  }
  if ((parts & 4) && skv > 0) {
    const int blocks = banded ? (G + kBlockRows - 1) / kBlockRows + n_frames * ((tpf + kBlockRows - 1) / kBlockRows)
                              : (skv + kBlockRows - 1) / kBlockRows;
    if ((err = make_plane_map(&p.res_map, pl.v, kD, skv, 2LL * bh, kBlockRows)) != 0) return err;
    if ((err = make_plane_map(&p.a_map, pl.q, kD, sq, 2LL * bh, kTile)) != 0) return err;
    if ((err = make_plane_map(&p.b_map, pl.g, kD, sq, 2LL * bh, kTile)) != 0) return err;
    if ((err = make_plane_map(&p.at_map, pl.qt, pad_seq(sq), kD, 2LL * bh, kD)) != 0) return err;
    if ((err = make_plane_map(&p.bt_map, pl.gt, pad_seq(sq), kD, 2LL * bh, kD)) != 0) return err;
    p.frag_planes = pl.k;
    if (blocks > 0) {
      cudaError_t e = cudaFuncSetAttribute(dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kDkvSmem);
      if (e != cudaSuccess) return static_cast<int>(e);
      dkv_kernel<<<dim3(blocks, bh), kThreads, kDkvSmem, st>>>(p);
      if ((err = static_cast<int>(cudaGetLastError())) != 0) return err;
    }
  }
  return 0;
}
