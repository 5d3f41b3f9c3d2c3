// fp32 attention forward for Hopper (sm_90a): kernels B1, B4 and B6 on fp32
// q, k, v, and kernel B3's fp32 form (int8 q.k^T, fp32 P.V); one kernel over
// a key range (or a band's two) per 128-query block.
//
// Replaces, for fp32 inputs (the JAX package's kernels compute in the input's
// own type, s2v_tpu/ops/pallas/flash_attention.py:106,163):
//   B1  s2v_tpu/ops/pallas/flash_attention.py::flash_attention (online and
//       bounded softmax, lse, key pad mask): every query block walks [0, Skv);
//   B4  s2v_tpu/ops/pallas/banded_attention.py::banded_flash_attention (the
//       video queries; its global queries are one B1 call): a block of one
//       query frame walks the global keys and the frame's window
//       (band.cuh's key walk);
//   B6  banded_attention.py::banded_flash_attention_local: B4 on one rank's
//       frame shard at a runtime frame offset (frames past F take the last
//       window, as the clamp gives);
//   B3  s2v_tpu/ops/pallas/int8_attention.py::flash_attention_qk_int8 on fp32
//       q, k, v: the logits from the int8 pre-pass (int8_attention.cu, entry
//       s2v_int8_prepass_f32) exact in int32 on wgmma m64n64k32 s8 from
//       TMA-loaded int8 tiles, times the device scalar dq; online softmax;
//       P.V in 3xTF32.
//
// Bound on an H100 SXM at the main-path shape (B=2, H=48, S=19,126, d=64):
// 4*B*H*S^2*d = 9.0e12 operations, 18.2 ms at the 495 TFLOP/s TF32 dense
// peak; three TF32 passes (3xTF32) make 54.5 ms the floor.  B3's int8
// logits are 4.5e12 operations (2.3 ms at 1,979 TOPS) and its P.V 27.2 ms at
// the 3-pass floor.  Bytes (1.9 GB of fp32 q/k/v/o, 2.8 GB of planes
// written and read once more, 1.4 ms) do not bound them.
//
// Design: the pre-pass (attention_f32.cuh) writes q's and k's row planes and
// v's transposed planes.  A block has two consumer warpgroups of 64 query
// rows and no producer warpgroup: thread 0 issues the TMA loads of 64-key
// tiles (K's big and small row planes, V's transposed ones: 64 KB) two
// tiles ahead through a ring of three stages (full/empty mbarriers, 192 KB).
// Each warpgroup reads its q fragments from q's planes into registers once;
// S = q.K^T is 24 wgmma m64n64k8 tf32 (three passes of 8 k8 steps, A from
// registers); the softmax is fp32 with exp2f; P's fragments are made from
// the S accumulator (a shuffle within each row's four threads, then the
// split) and O += P.V is 24 more wgmma against V's transposed planes, the
// tile's sum from zero and added to O in fp32 (the tensor cores'
// accumulation truncates).  A tile's P.V runs on while the next tile's S is
// issued.  Keys past their range's end or masked are -inf
// on the logits; query rows past the block's end are not stored.
//
// Modes: online (running max, lse = m + log l) and bounded (p =
// exp2(s*scale_log2 - m0), m0 read from the device, no running max; emits
// log l for the wrapper's add-back and underflow re-run).  Rows with every
// key masked give a zero output and a -1e30 lse.

#include "attention_f32.cuh"

namespace {

using namespace f32attn;

constexpr int kKeys = 64;  // keys per tile
constexpr int kStages = 3;
constexpr int kTileFloats = kKeys * kD;  // one plane of a 64 x 64 tile, 16 KB

template <bool I8>
struct Smem {
  float vt[kStages][2][kTileFloats];             // V^T big, small: [64 d][64 keys] as two 32-key halves
  float k[I8 ? 1 : kStages][2][kTileFloats];     // K big, small: [64 keys][64 d] as two 32-column halves
  int8_t k8[I8 ? kStages : 1][kKeys * kD];       // B3: int8 K, 64B-swizzled
  int8_t q8[I8 ? kBlockRows * kD : 1024];        // B3: int8 q of the block
  uint64_t full[kStages];
  uint64_t empty[kStages];
  uint64_t q_full;
};

template <bool I8>
constexpr int smem_bytes() {
  return int(sizeof(Smem<I8>)) + 1024;
}

struct FwdParams {
  CUtensorMap k_map;   // K's row planes, box (32, 64)
  CUtensorMap vt_map;  // V's transposed planes, box (32, 64)
  CUtensorMap q8_map;  // B3: int8 q, box (64, 128)
  CUtensorMap k8_map;  // B3: int8 k, box (64, 64)
  const float* qp;     // q's row planes [2, B*H, sq, 64]
  const float* dq8;    // B3's logit dequant qs*ks, a device scalar
  float* o;
  float* lse;
  const unsigned char* mask;
  const float* m0_log2;
  int heads, bh_total, sq, skv;
  long long o_sb, o_ss, o_sh;
  int lse_ld;
  float scale_log2;
  int bounded;
  Band band;
};

// int32 -> fp32, exact for |x| < 2^22 (here |x| <= 127^2 * 64 < 2^20)
__device__ __forceinline__ float exact_i2f(int x) { return __int_as_float(x + 0x4B400000) - 12582912.0f; }

template <bool I8>
__device__ __forceinline__ void load_stage(const FwdParams& p, Smem<I8>& sm, int j, const AlignedWalk<kKeys>& walk,
                                           int b, int h, int bh) {
  int k0, klo, kend;
  walk.tile(j, k0, klo, kend);
  const int st = j % kStages;
  uint64_t* bar = &sm.full[st];
  if constexpr (I8) {
    mbar_arrive_expect_tx(bar, kKeys * kD + 2 * kTileFloats * 4);
    tma_load_rows(sm.k8[st], &p.k8_map, bar, k0, h, b);
  } else {
    mbar_arrive_expect_tx(bar, 4 * kTileFloats * 4);
    load_row_tile(sm.k[st][0], &p.k_map, bar, k0, bh, kKeys);
    load_row_tile(sm.k[st][1], &p.k_map, bar, k0, p.bh_total + bh, kKeys);
  }
  load_cols_tile(sm.vt[st][0], &p.vt_map, bar, k0, bh, 2);
  load_cols_tile(sm.vt[st][1], &p.vt_map, bar, k0, p.bh_total + bh, 2);
}

template <bool I8>
__global__ void __launch_bounds__(kThreads, 1) fwd_kernel(const __grid_constant__ FwdParams p) {
  extern __shared__ uint8_t smem_raw[];
  Smem<I8>& sm = *reinterpret_cast<Smem<I8>*>(align_1024(smem_raw));
  const int tid = threadIdx.x, lane = tid & 31, t = lane & 3, g = lane >> 2;
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);  // warp-uniform
  const int bh = blockIdx.y, b = bh / p.heads, h = bh % p.heads;

  int r0, r_end;
  band::KeyWalk keys;
  if (p.band.banded) {
    const int per_frame = (p.band.tpf + kBlockRows - 1) / kBlockRows;
    const int fl = blockIdx.x / per_frame;
    r0 = fl * p.band.tpf + (blockIdx.x % per_frame) * kBlockRows;
    r_end = min(r0 + kBlockRows, (fl + 1) * p.band.tpf);
    const int ws = band::window_start(p.band.frame_offset + fl, p.band.window, p.band.n_frames, p.band.span);
    keys = band::key_walk<kKeys>(p.band.G, p.band.tpf, ws, p.band.span);
  } else {
    r0 = blockIdx.x * kBlockRows;
    r_end = min(r0 + kBlockRows, p.sq);
    keys = full_walk<kKeys>(p.skv);
  }
  const AlignedWalk<kKeys> walk(keys);
  const int row0 = r0 + wg * kWgRows + ((tid >> 5) & 3) * 16;  // this warp's first row
  const int valid = r_end - row0;

  if (tid == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&sm.full[st], 1);
      mbar_init(&sm.empty[st], kConsumers * 4);  // one arrival per consumer warp
    }
    mbar_init(&sm.q_full, 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    if constexpr (I8) {
      prefetch_tensor_map(&p.q8_map);
      prefetch_tensor_map(&p.k8_map);
      mbar_arrive_expect_tx(&sm.q_full, kBlockRows * kD);  // rows past sq arrive as zeros, never stored
      tma_load_rows(sm.q8, &p.q8_map, &sm.q_full, r0, h, b);
    } else {
      prefetch_tensor_map(&p.k_map);
    }
    prefetch_tensor_map(&p.vt_map);
    for (int j = 0; j < kStages - 1 && j < walk.n_tiles; ++j) load_stage<I8>(p, sm, j, walk, b, h, bh);
  }

  // this warp's q fragments, split once: all 8 k8 chunks of d, big and small
  uint32_t qb[I8 ? 1 : 8][4], qs[I8 ? 1 : 8][4];
  float c;
  if constexpr (I8) {
    c = *p.dq8 * kLog2e;
    mbar_wait(&sm.q_full, 0);
  } else {
    const float* big = p.qp + ((long long)bh * p.sq + row0) * kD;
    load_a_planes(big, big + (long long)p.bh_total * p.sq * kD, valid, qb, qs);
    c = p.scale_log2;
  }

  float m[2], l[2] = {0.f, 0.f};
  m[0] = m[1] = p.bounded ? *p.m0_log2 : kNegInit;
  float o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;

  // Tile j's P.V stays in flight while tile j + 1's S is issued; it is
  // waited for, added and its stage released after that, and the producer's
  // step follows the release.
  float pv[32];
  uint32_t pb[8][4], ps[8][4];
  for (int j = 0; j < walk.n_tiles; ++j) {
    int k0, klo, kend;
    walk.tile(j, k0, klo, kend);
    const int st = j % kStages;
    mbar_wait(&sm.full[st], (j / kStages) & 1);

    float s[32];
    int si[32];
    wgmma_fence();
    if constexpr (I8) {
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
        wgmma_s8_ss_n64(si, desc_kmajor_s8(sm.q8 + wg * kWgRows * kD, kk), desc_kmajor_s8(sm.k8[st], kk), kk);
    } else {
#pragma unroll
      for (int pass = 0; pass < 3; ++pass)  // small.big, big.small, big.big
#pragma unroll
        for (int kk = 0; kk < 8; ++kk)
          wgmma_tf32_rs_n64(s, pass == 0 ? qs[kk] : qb[kk], desc_k8(sm.k[st][pass == 1], kKeys, kk), pass | kk);
    }
    wgmma_commit();
    if (j > 0) {  // tile j - 1's P.V: done once at most one group (this S) is pending
      wgmma_wait<1>();
      fence_regs(pv);
      fence_regs(pb);
      fence_regs(ps);
#pragma unroll
      for (int i = 0; i < 32; ++i) o[i] += pv[i];
      if (lane == 0) mbar_arrive(&sm.empty[(j - 1) % kStages]);
    }
    if (tid == 0) {
      // the producer's step: tile j + kStages - 1 into the stage tile j - 1
      // used, once every consumer warp released it (round 0 passes at once)
      const int jn = j + kStages - 1;
      if (jn < walk.n_tiles) {
        mbar_wait(&sm.empty[jn % kStages], ((jn / kStages) & 1) ^ 1);
        load_stage<I8>(p, sm, jn, walk, b, h, bh);
      }
    }
    __syncwarp();
    wgmma_wait<0>();
    if constexpr (I8) {
      fence_regs(si);
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = exact_i2f(si[i]);
    } else {
      fence_regs(s);
    }

    if (k0 < klo || k0 + kKeys > kend || p.mask != nullptr) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int key = k0 + (i >> 2) * 8 + 2 * t + (i & 1);
        if (key < klo || key >= kend || (p.mask != nullptr && p.mask[key])) s[i] = -INFINITY;
      }
    }

    float alpha[2] = {1.f, 1.f};
    if (!p.bounded) {
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        mx[0] = fmaxf(mx[0], fmaxf(s[4 * n], s[4 * n + 1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[4 * n + 2], s[4 * n + 3]));
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r] * c);
        alpha[r] = exp2f(m[r] - m_new);
        m[r] = m_new;
      }
    }
    float ls[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      s[i] = exp2f(s[i] * c - m[(i >> 1) & 1]);
      ls[(i >> 1) & 1] += s[i];
      o[i] *= alpha[(i >> 1) & 1];
    }
    l[0] = l[0] * alpha[0] + ls[0];
    l[1] = l[1] * alpha[1] + ls[1];

    // the tile's P.V from a zero accumulator, added to O in fp32 (the tensor
    // cores' accumulation truncates: summed into the running O across
    // hundreds of tiles it drifted 1e-4 from the plain version at the main
    // shape, where each tile's own sum stays at fp32's rounding)
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) acc_to_a(s + 4 * kk, pb[kk], ps[kk]);
    wgmma_fence();
#pragma unroll
    for (int pass = 0; pass < 3; ++pass)
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        wgmma_tf32_rs_n64(pv, pass == 0 ? ps[kk] : pb[kk], desc_k8(sm.vt[st][pass == 1], kD, kk), pass | kk);
    wgmma_commit();
  }
  if (walk.n_tiles > 0) {
    wgmma_wait<0>();
    fence_regs(pv);
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] += pv[i];
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  // o = acc / l, as a division (the plain versions divide); 0 where l = 0
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const float li = l[(i >> 1) & 1];
    o[i] = li > 0.f ? o[i] / li : 0.f;
  }
  store_acc_rows(p.o + b * p.o_sb + h * p.o_sh + (long long)row0 * p.o_ss, p.o_ss, o, 1.f, valid);
  if (p.lse != nullptr && t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = g + 8 * r;
      if (row >= valid) continue;
      float val = -1e30f;
      if (l[r] > 0.f) val = p.bounded ? logf(l[r]) : m[r] * kLn2 + logf(l[r]);
      p.lse[(long long)bh * p.lse_ld + row0 + row] = val;
    }
  }
}

template <bool I8>
int launch(const FwdParams& p, int blocks, int bh, cudaStream_t st) {
  if (blocks == 0 || bh == 0) return 0;
  constexpr int bytes = smem_bytes<I8>();
  cudaError_t err = cudaFuncSetAttribute(fwd_kernel<I8>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  fwd_kernel<I8><<<dim3(blocks, bh), kThreads, bytes, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int s2v_attention_f32_fwd_smem_bytes() { return smem_bytes<false>(); }
extern "C" int s2v_flash_attention_qk_int8_fwd_f32_smem_bytes() { return smem_bytes<true>(); }

// floats of the planes workspace of one forward (q's and k's row planes, v's
// transposed planes) and of one fp32 B3 launch (v's transposed planes)
extern "C" long long s2v_attention_f32_fwd_planes(int batch, int heads, int sq, int skv) {
  const int bh = batch * heads;
  return row_planes(bh, sq) + row_planes(bh, skv) + col_planes(bh, skv);
}
extern "C" long long s2v_flash_attention_qk_int8_fwd_f32_planes(int batch, int heads, int skv) {
  return col_planes(batch * heads, skv);
}

// q [B, sq, H, 64] (for a band: the video rows of the call, local_frames x
// tpf), k and v [B, skv, H, 64], o like q, fp32, element strides (batch,
// seq, head), rows 16-byte aligned; planes a workspace of
// s2v_attention_f32_fwd_planes floats (the pre-pass writes q's, k's and v's
// planes there); lse (or null) at lse[(b*H + h)*lse_ld + row]; key_mask (or
// null) one byte per key, nonzero excluded; m0_log2 a device scalar in
// bounded mode.  Returns 0 or an error code.
extern "C" int s2v_attention_f32_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse, const void* key_mask, const void* m0_log2,
    void* planes, int batch, int heads, int sq, int skv,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    int lse_ld, float scale_log2, int bounded,
    int banded, int G, int tpf, int n_frames, int span, int window, int frame_offset, int local_frames,
    void* stream) {
  const int bh = batch * heads;
  if (bh == 0 || sq == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* qp = static_cast<float*>(planes);
  float* kp = qp + row_planes(bh, sq);
  float* vtp = kp + row_planes(bh, skv);
  int err = launch_split_rows(static_cast<const float*>(q), qp, batch, heads, sq, q_sb, q_ss, q_sh, st);
  if (err == 0) err = launch_split_rows(static_cast<const float*>(k), kp, batch, heads, skv, k_sb, k_ss, k_sh, st);
  if (err == 0) err = launch_split_cols(static_cast<const float*>(v), vtp, batch, heads, skv, v_sb, v_ss, v_sh, st);
  if (err != 0) return err;
  FwdParams p = {};
  if ((err = make_plane_map(&p.k_map, kp, kD, skv, 2LL * bh, kKeys)) != 0) return err;
  if ((err = make_plane_map(&p.vt_map, vtp, pad_seq(skv), kD, 2LL * bh, kD)) != 0) return err;
  p.qp = qp;
  p.o = static_cast<float*>(o);
  p.lse = static_cast<float*>(lse);
  p.mask = static_cast<const unsigned char*>(key_mask);
  p.m0_log2 = static_cast<const float*>(m0_log2);
  p.heads = heads;
  p.bh_total = bh;
  p.sq = sq;
  p.skv = skv;
  p.o_sb = o_sb; p.o_ss = o_ss; p.o_sh = o_sh;
  p.lse_ld = lse_ld;
  p.scale_log2 = scale_log2;
  p.bounded = bounded;
  p.band = Band{banded, G, tpf, n_frames, span, window, frame_offset, local_frames};
  const int blocks = banded ? local_frames * ((tpf + kBlockRows - 1) / kBlockRows) : (sq + kBlockRows - 1) / kBlockRows;
  return launch<false>(p, blocks, bh, st);
}

// Kernel B3 in fp32: q_i8 [B, sq, H, 64] and k_i8 [B, skv, H, 64] int8,
// contiguous (the pre-pass's), v [B, skv, H, 64] and o [B, sq, H, 64] fp32
// with element strides; dq the pre-pass's device scalar; planes a workspace
// of s2v_flash_attention_qk_int8_fwd_f32_planes floats for v's transposed
// planes.  Returns 0 or an error code.
extern "C" int s2v_flash_attention_qk_int8_fwd_f32(
    const void* q_i8, const void* k_i8, const void* v, void* o, const void* dq, void* planes, int batch, int heads,
    int sq, int skv, long long v_sb, long long v_ss, long long v_sh, long long o_sb, long long o_ss, long long o_sh,
    void* stream) {
  const int bh = batch * heads;
  if (bh == 0 || sq == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* vtp = static_cast<float*>(planes);
  int err = launch_split_cols(static_cast<const float*>(v), vtp, batch, heads, skv, v_sb, v_ss, v_sh, st);
  if (err != 0) return err;
  FwdParams p = {};
  const long long row = (long long)heads * kD;  // int8 elements between consecutive rows of one (b, h)
  if ((err = make_bshd_map_s8(&p.q8_map, q_i8, batch, sq, heads, sq * row, row, kD, kBlockRows)) != 0) return err;
  if ((err = make_bshd_map_s8(&p.k8_map, k_i8, batch, skv, heads, skv * row, row, kD, kKeys)) != 0) return err;
  if ((err = make_plane_map(&p.vt_map, vtp, pad_seq(skv), kD, 2LL * bh, kD)) != 0) return err;
  p.dq8 = static_cast<const float*>(dq);
  p.o = static_cast<float*>(o);
  p.heads = heads;
  p.bh_total = bh;
  p.sq = sq;
  p.skv = skv;
  p.o_sb = o_sb; p.o_ss = o_ss; p.o_sh = o_sh;
  return launch<true>(p, (sq + kBlockRows - 1) / kBlockRows, bh, st);
}
