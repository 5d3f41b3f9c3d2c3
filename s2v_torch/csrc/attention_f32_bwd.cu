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
// Design (simple first): the pre-pass writes lse*log2 e and D per query row
// into an fp32 workspace [2, B*H, sq]; the dq kernel holds 64 query rows
// (q, dO) and streams 64-key K/V tiles; the dk/dv kernel holds 64 keys (K,
// V) and streams 64-query q/dO tiles with their workspace rows; both with
// two cp.async stages and four warps of 16 rows, every product mma.sync
// m16n8k8 tf32 as 3xTF32 (attention_f32.cuh), each tile's product summed
// from zero and added to dq, dk, dv in fp32.  Every output is written by
// one block, so a launch is deterministic bit for bit.

#include "attention_f32.cuh"
#include "band.cuh"

namespace {

using namespace f32attn;

struct BwdArgs {
  const float *q, *k, *v, *o, *dout, *lse;
  float* ws;  // [2, B*H, sq]: lse*log2 e, then D
  float *dq, *dk, *dv;
  int heads, sq, skv;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh, g_sb, g_ss, g_sh;
  long long dq_sb, dq_ss, dq_sh, dk_sb, dk_ss, dk_sh, dv_sb, dv_ss, dv_sh;
  int lse_ld;
  int bh_total;
  float scale;
  Band band;
};

constexpr int kDqSmem = 6 * kTileFloats * int(sizeof(float));                              // q, dO, K x2, V x2
constexpr int kDkvSmem = 6 * kTileFloats * int(sizeof(float)) + 4 * kRows * int(sizeof(float));  // + lse2, D x2

// the query rows that hold a real frame (a band's shard may end in dummy frames)
__device__ __forceinline__ int real_rows(const BwdArgs& a) {
  if (!a.band.banded) return a.sq;
  const int frames = max(0, min(a.band.local_frames, a.band.n_frames - a.band.frame_offset));
  return frames * a.band.tpf;
}

// one warp per query row: lse*log2 e and D = rowsum(dO o)
__global__ void __launch_bounds__(kThreads) prepass_kernel(const BwdArgs a) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * (kThreads / 32) + warp;
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

__global__ void __launch_bounds__(kThreads) dq_kernel(const BwdArgs a) {
  extern __shared__ __align__(16) float smem[];
  float* s_q = smem;
  float* s_g = s_q + kTileFloats;
  float* s_k = s_g + kTileFloats;
  float* s_v = s_k + 2 * kTileFloats;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / a.heads, h = bh % a.heads;

  int r0, r_end;
  band::KeyWalk walk;
  if (a.band.banded) {
    const int per_frame = (a.band.tpf + kRows - 1) / kRows;
    const int fl = blockIdx.x / per_frame;
    r0 = fl * a.band.tpf + (blockIdx.x % per_frame) * kRows;
    r_end = min(r0 + kRows, (fl + 1) * a.band.tpf);
    const int ws = band::window_start(a.band.frame_offset + fl, a.band.window, a.band.n_frames, a.band.span);
    walk = band::key_walk<kRows>(a.band.G, a.band.tpf, ws, a.band.span);
    if (r0 >= real_rows(a)) walk.n_tiles = 0;  // a dummy frame: dq = 0
  } else {
    r0 = blockIdx.x * kRows;
    r_end = min(r0 + kRows, a.sq);
    walk.end0 = a.skv;
    walk.n_first = (a.skv + kRows - 1) / kRows;
    walk.win_lo = walk.win_hi = a.skv;
    walk.n_tiles = walk.n_first;
  }
  const int row0 = r0 + warp * 16;
  const int valid = r_end - row0;

  const float* kb = a.k + b * a.k_sb + h * a.k_sh;
  const float* vb = a.v + b * a.v_sb + h * a.v_sh;
  load_tile(s_q, a.q + b * a.q_sb + h * a.q_sh, a.q_ss, r0, r_end, tid);
  load_tile(s_g, a.dout + b * a.g_sb + h * a.g_sh, a.g_ss, r0, r_end, tid);
  if (walk.n_tiles > 0) {
    int k0, kend;
    band::tile_keys<kRows>(walk, 0, k0, kend);
    load_tile(s_k, kb, a.k_ss, k0, a.skv, tid);
    load_tile(s_v, vb, a.v_ss, k0, a.skv, tid);
  }
  cp_async_commit();

  // this thread's rows g and g + 8: lse*log2 e and D (rows past the end read row r0)
  float lse2[2], dd[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r < r_end ? row0 + g + 8 * r : r0;
    lse2[r] = a.ws[(long long)bh * a.sq + row];
    dd[r] = a.ws[(long long)(a.bh_total + bh) * a.sq + row];
  }
  const float c = a.scale * kLog2e;
  float dq[8][4];
  zero(dq);
  const float* q_warp = s_q + warp * 16 * kPitch;
  const float* g_warp = s_g + warp * 16 * kPitch;

  for (int j = 0; j < walk.n_tiles; ++j) {
    int k0, kend;
    band::tile_keys<kRows>(walk, j, k0, kend);
    if (j + 1 < walk.n_tiles) {
      int n0, nend;
      band::tile_keys<kRows>(walk, j + 1, n0, nend);
      load_tile(s_k + ((j + 1) & 1) * kTileFloats, kb, a.k_ss, n0, a.skv, tid);
      load_tile(s_v + ((j + 1) & 1) * kTileFloats, vb, a.v_ss, n0, a.skv, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* K = s_k + (j & 1) * kTileFloats;
    const float* V = s_v + (j & 1) * kTileFloats;

    float s[8][4], dp[8][4];
    zero(s);
    zero(dp);
    product_rows(s, q_warp, K, g, t);
    product_rows(dp, g_warp, V, g, t);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + n * 8 + 2 * t + (e & 1);
        const float p = key < kend ? exp2f(s[n][e] * c - lse2[e >> 1]) : 0.f;
        s[n][e] = p * (dp[n][e] - dd[e >> 1]);  // dS
      }
    float part[8][4];  // this tile's dS.K from zero, added in fp32 (see attention_f32.cuh)
    zero(part);
    product_acc(part, s, K, g, t);
    add(dq, part);
    __syncthreads();
  }
  cp_async_wait<0>();
  store_rows(a.dq + b * a.dq_sb + h * a.dq_sh + (long long)row0 * a.dq_ss, a.dq_ss, dq, a.scale, a.scale, g, t,
             valid);
}

__global__ void __launch_bounds__(kThreads) dkv_kernel(const BwdArgs a) {
  extern __shared__ __align__(16) float smem[];
  float* s_k = smem;
  float* s_v = s_k + kTileFloats;
  float* s_q = s_v + kTileFloats;       // x2
  float* s_g = s_q + 2 * kTileFloats;   // x2
  float* s_l = s_g + 2 * kTileFloats;   // lse2 x2
  float* s_d = s_l + 2 * kRows;         // D x2
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / a.heads, h = bh % a.heads;

  // the block's keys [k0, k_end) and the query rows [q_lo, q_hi) that attend them
  int k0, k_end, q_lo, q_hi;
  if (a.band.banded) {
    const int n_glob = (a.band.G + kRows - 1) / kRows;
    if (blockIdx.x < n_glob) {
      k0 = blockIdx.x * kRows;
      k_end = min(k0 + kRows, a.band.G);
      q_lo = 0;
      q_hi = real_rows(a);
    } else {
      const int per_frame = (a.band.tpf + kRows - 1) / kRows;
      const int j = blockIdx.x - n_glob, fk = j / per_frame;
      k0 = a.band.G + fk * a.band.tpf + (j % per_frame) * kRows;
      k_end = min(k0 + kRows, a.band.G + (fk + 1) * a.band.tpf);
      int f_lo, f_hi;
      band::inverse_band(fk, a.band.window, a.band.n_frames, a.band.span, f_lo, f_hi);
      const int lo = max(f_lo, a.band.frame_offset);
      const int hi = min(f_hi, a.band.frame_offset + a.band.local_frames - 1);
      q_lo = (lo - a.band.frame_offset) * a.band.tpf;
      q_hi = hi >= lo ? (hi - a.band.frame_offset + 1) * a.band.tpf : q_lo;
    }
  } else {
    k0 = blockIdx.x * kRows;
    k_end = min(k0 + kRows, a.skv);
    q_lo = 0;
    q_hi = a.sq;
  }
  const int n_tiles = (q_hi - q_lo + kRows - 1) / kRows;

  const float* qb = a.q + b * a.q_sb + h * a.q_sh;
  const float* gb = a.dout + b * a.g_sb + h * a.g_sh;
  const float* ws_l = a.ws + (long long)bh * a.sq;
  const float* ws_d = a.ws + (long long)(a.bh_total + bh) * a.sq;
  load_tile(s_k, a.k + b * a.k_sb + h * a.k_sh, a.k_ss, k0, k_end, tid);
  load_tile(s_v, a.v + b * a.v_sb + h * a.v_sh, a.v_ss, k0, k_end, tid);
  auto load_queries = [&](int stage, int qb0) {
    load_tile(s_q + stage * kTileFloats, qb, a.q_ss, qb0, q_hi, tid);
    load_tile(s_g + stage * kTileFloats, gb, a.g_ss, qb0, q_hi, tid);
    if (tid < kRows) {
      const int row = qb0 + tid;
      const bool ok = row < q_hi;
      s_l[stage * kRows + tid] = ok ? ws_l[row] : INFINITY;  // P = exp2(-inf) = 0 past the range
      s_d[stage * kRows + tid] = ok ? ws_d[row] : 0.f;
    }
  };
  if (n_tiles > 0) load_queries(0, q_lo);
  cp_async_commit();

  const float c = a.scale * kLog2e;
  float dk[8][4], dv[8][4];
  zero(dk);
  zero(dv);
  const float* k_warp = s_k + warp * 16 * kPitch;
  const float* v_warp = s_v + warp * 16 * kPitch;

  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) load_queries((j + 1) & 1, q_lo + (j + 1) * kRows);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* Q = s_q + (j & 1) * kTileFloats;
    const float* G = s_g + (j & 1) * kTileFloats;
    const float* L = s_l + (j & 1) * kRows;
    const float* D = s_d + (j & 1) * kRows;

    // P^T and dP^T: rows are this warp's 16 keys, columns the tile's 64 queries
    float p[8][4], dp[8][4];
    zero(p);
    zero(dp);
    product_rows(p, k_warp, Q, g, t);
    product_rows(dp, v_warp, G, g, t);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n * 8 + 2 * t + (e & 1);
        p[n][e] = exp2f(p[n][e] * c - L[col]);
        dp[n][e] = p[n][e] * (dp[n][e] - D[col]);  // dS^T
      }
    // each tile's products from zero, added in fp32 (see attention_f32.cuh);
    // P is dead after P^T.dO and holds dS^T.q
    float part[8][4];
    zero(part);
    product_acc(part, p, G, g, t);
    add(dv, part);
    zero(p);
    product_acc(p, dp, Q, g, t);
    add(dk, p);
    __syncthreads();
  }
  cp_async_wait<0>();
  const int row0 = k0 + warp * 16;
  const int valid = k_end - row0;
  store_rows(a.dk + b * a.dk_sb + h * a.dk_sh + (long long)row0 * a.dk_ss, a.dk_ss, dk, a.scale, a.scale, g, t,
             valid);
  store_rows(a.dv + b * a.dv_sb + h * a.dv_sh + (long long)row0 * a.dv_ss, a.dv_ss, dv, 1.f, 1.f, g, t, valid);
}

}  // namespace

extern "C" int s2v_attention_f32_bwd_smem_bytes() { return kDkvSmem; }

// parts: 1 the pre-pass, 2 the dq kernel, 4 the dk/dv kernel
extern "C" int s2v_attention_f32_bwd(
    const void* q, const void* k, const void* v, const void* o, const void* dout, const void* lse, void* ws,
    void* dq, void* dk, void* dv, int batch, int heads, int sq, int skv,
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
  BwdArgs a;
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.o = static_cast<const float*>(o);
  a.dout = static_cast<const float*>(dout);
  a.lse = static_cast<const float*>(lse);
  a.ws = static_cast<float*>(ws);
  a.dq = static_cast<float*>(dq);
  a.dk = static_cast<float*>(dk);
  a.dv = static_cast<float*>(dv);
  a.heads = heads;
  a.sq = sq;
  a.skv = skv;
  a.q_sb = q_sb; a.q_ss = q_ss; a.q_sh = q_sh;
  a.k_sb = k_sb; a.k_ss = k_ss; a.k_sh = k_sh;
  a.v_sb = v_sb; a.v_ss = v_ss; a.v_sh = v_sh;
  a.o_sb = o_sb; a.o_ss = o_ss; a.o_sh = o_sh;
  a.g_sb = g_sb; a.g_ss = g_ss; a.g_sh = g_sh;
  a.dq_sb = dq_sb; a.dq_ss = dq_ss; a.dq_sh = dq_sh;
  a.dk_sb = dk_sb; a.dk_ss = dk_ss; a.dk_sh = dk_sh;
  a.dv_sb = dv_sb; a.dv_ss = dv_ss; a.dv_sh = dv_sh;
  a.lse_ld = lse_ld;
  a.bh_total = batch * heads;
  a.scale = scale;
  a.band = Band{banded, G, tpf, n_frames, span, window, frame_offset, local_frames};
  if (batch * heads == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if ((parts & 1) && sq > 0) {
    prepass_kernel<<<dim3((sq + 3) / 4, batch * heads), kThreads, 0, st>>>(a);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  if (parts & 2) {
    const int blocks = banded ? local_frames * ((tpf + kRows - 1) / kRows) : (sq + kRows - 1) / kRows;
    if (blocks > 0) {
      err = cudaFuncSetAttribute(dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kDqSmem);
      if (err != cudaSuccess) return static_cast<int>(err);
      dq_kernel<<<dim3(blocks, batch * heads), kThreads, kDqSmem, st>>>(a);
      if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    }
  }
  if (parts & 4) {
    const int blocks = banded ? (G + kRows - 1) / kRows + n_frames * ((tpf + kRows - 1) / kRows)
                              : (skv + kRows - 1) / kRows;
    if (blocks > 0) {
      err = cudaFuncSetAttribute(dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kDkvSmem);
      if (err != cudaSuccess) return static_cast<int>(err);
      dkv_kernel<<<dim3(blocks, batch * heads), kThreads, kDkvSmem, st>>>(a);
      if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    }
  }
  return 0;
}
