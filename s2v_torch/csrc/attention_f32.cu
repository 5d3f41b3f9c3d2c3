// fp32 attention forward for Hopper (sm_90a): kernels B1, B4 and B6 on fp32
// q, k, v, one kernel over a key range (or a band's two) per query block.
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
//       window, as the clamp gives).
//
// Bound on an H100 SXM at the main-path shape (B=2, H=48, S=19,126, d=64):
// 4*B*H*S^2*d = 9.0e12 operations, 18.2 ms at the 495 TFLOP/s TF32 dense
// peak; three TF32 passes (3xTF32) make 54.6 ms the floor of this design.
// Bytes (1.9 GB of fp32 q/k/v/o, 0.56 ms) do not bound it.
//
// Design (simple first, ROADMAP C.1): 128 threads per block, four warps of
// 16 query rows; the block's 64 query rows stay in shared memory, 64-key K
// and V tiles stream through two cp.async stages; every product is
// mma.sync m16n8k8 tf32 as 3xTF32 (attention_f32.cuh), S and O in fp32
// registers, the softmax in fp32 with exp2f; P is split from the S
// accumulator as the A operand of P.V, whose tile sum starts from zero and is
// added to O in fp32 (attention_f32.cuh: the tensor cores' accumulation
// truncates, so no sum runs across tiles inside them).  Keys past their range's end or
// masked are -inf on the logits; query rows past the block's end are not
// stored.
//
// Modes: online (running max, lse = m + log l) and bounded (p =
// exp2(s*scale_log2 - m0), m0 read from the device, no running max; emits
// log l for the wrapper's add-back and underflow re-run).  Rows with every
// key masked give a zero output and a -1e30 lse.

#include "attention_f32.cuh"
#include "band.cuh"

namespace {

using namespace f32attn;

struct FwdArgs {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  float* lse;
  const unsigned char* mask;
  const float* m0_log2;
  int heads, sq, skv;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh;
  int lse_ld;
  float scale_log2;
  int bounded;
  Band band;
};

constexpr int kSmemBytes = 5 * kTileFloats * int(sizeof(float));  // q, K x2, V x2

__global__ void __launch_bounds__(kThreads) fwd_kernel(const FwdArgs a) {
  extern __shared__ __align__(16) float smem[];
  float* s_q = smem;
  float* s_k = s_q + kTileFloats;
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
  } else {
    r0 = blockIdx.x * kRows;
    r_end = min(r0 + kRows, a.sq);
    walk.end0 = a.skv;
    walk.n_first = (a.skv + kRows - 1) / kRows;
    walk.win_lo = walk.win_hi = a.skv;
    walk.n_tiles = walk.n_first;
  }

  const float* qb = a.q + b * a.q_sb + h * a.q_sh;
  const float* kb = a.k + b * a.k_sb + h * a.k_sh;
  const float* vb = a.v + b * a.v_sb + h * a.v_sh;
  load_tile(s_q, qb, a.q_ss, r0, r_end, tid);
  if (walk.n_tiles > 0) {
    int k0, kend;
    band::tile_keys<kRows>(walk, 0, k0, kend);
    load_tile(s_k, kb, a.k_ss, k0, a.skv, tid);
    load_tile(s_v, vb, a.v_ss, k0, a.skv, tid);
  }
  cp_async_commit();

  const float c = a.scale_log2;
  float m[2], l[2] = {0.f, 0.f};
  m[0] = m[1] = a.bounded ? *a.m0_log2 : kNegInit;
  float o[8][4];
  zero(o);
  const float* q_warp = s_q + warp * 16 * kPitch;

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

    float s[8][4];
    zero(s);
    product_rows(s, q_warp, K, g, t);

    if (k0 + kRows > kend || a.mask != nullptr) {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + n * 8 + 2 * t + (e & 1);
          if (key >= kend || (a.mask != nullptr && a.mask[key])) s[n][e] = -INFINITY;
        }
    }

    float alpha[2] = {1.f, 1.f};
    if (!a.bounded) {
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
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
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = exp2f(s[n][e] * c - m[e >> 1]);
      ls[0] += s[n][0] + s[n][1];
      ls[1] += s[n][2] + s[n][3];
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }
    l[0] = l[0] * alpha[0] + ls[0];
    l[1] = l[1] * alpha[1] + ls[1];

    // the tile's P.V from a zero accumulator, added to O in fp32 (the tensor
    // cores' accumulation truncates: summed into the running O across
    // hundreds of tiles it drifted 1e-4 from the plain version at the main
    // shape, where each tile's own sum stays at fp32's rounding)
    float pv[8][4];
    zero(pv);
    product_acc(pv, s, V, g, t);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] += pv[n][e];
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const int row0 = r0 + warp * 16;
  const int valid = r_end - row0;
  // o = acc / l, as a division (the plain versions divide); 0 where l = 0
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = l[e >> 1] > 0.f ? o[n][e] / l[e >> 1] : 0.f;
  store_rows(a.o + b * a.o_sb + h * a.o_sh + (long long)row0 * a.o_ss, a.o_ss, o, 1.f, 1.f, g, t, valid);
  if (a.lse != nullptr && t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = g + 8 * r;
      if (row >= valid) continue;
      float val = -1e30f;
      if (l[r] > 0.f) val = a.bounded ? logf(l[r]) : m[r] * kLn2 + logf(l[r]);
      a.lse[(long long)bh * a.lse_ld + row0 + row] = val;
    }
  }
}

}  // namespace

extern "C" int s2v_attention_f32_fwd_smem_bytes() { return kSmemBytes; }

// q [B, sq, H, 64] (for a band: the video rows of the call, local_frames x
// tpf), k and v [B, skv, H, 64], o like q, fp32, element strides (batch,
// seq, head); lse (or null) at lse[(b*H + h)*lse_ld + row]; key_mask (or
// null) one byte per key, nonzero excluded; m0_log2 a device scalar in
// bounded mode.  Returns 0 or a cudaError_t.
extern "C" int s2v_attention_f32_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse, const void* key_mask, const void* m0_log2,
    int batch, int heads, int sq, int skv,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    int lse_ld, float scale_log2, int bounded,
    int banded, int G, int tpf, int n_frames, int span, int window, int frame_offset, int local_frames,
    void* stream) {
  FwdArgs a;
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.o = static_cast<float*>(o);
  a.lse = static_cast<float*>(lse);
  a.mask = static_cast<const unsigned char*>(key_mask);
  a.m0_log2 = static_cast<const float*>(m0_log2);
  a.heads = heads;
  a.sq = sq;
  a.skv = skv;
  a.q_sb = q_sb; a.q_ss = q_ss; a.q_sh = q_sh;
  a.k_sb = k_sb; a.k_ss = k_ss; a.k_sh = k_sh;
  a.v_sb = v_sb; a.v_ss = v_ss; a.v_sh = v_sh;
  a.o_sb = o_sb; a.o_ss = o_ss; a.o_sh = o_sh;
  a.lse_ld = lse_ld;
  a.scale_log2 = scale_log2;
  a.bounded = bounded;
  a.band = Band{banded, G, tpf, n_frames, span, window, frame_offset, local_frames};
  const int blocks = banded ? local_frames * ((tpf + kRows - 1) / kRows) : (sq + kRows - 1) / kRows;
  if (blocks == 0 || batch * heads == 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  fwd_kernel<<<dim3(blocks, batch * heads), kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
