// The q/k LayerNorms and the rotary embedding of the DiT's joint attention in
// one pass, for Hopper (sm_90a): q and k bf16 or fp16 [B, S, H, 64] (element
// strides: the views of the fused qkv output) -> normalised, rotated q and k,
// each [B, S, H, 64] contiguous in the same type.
//
// Replaces no TPU kernel: the JAX package leaves the q/k norms and RoPE to
// XLA, which fuses them.  In PyTorch the same chain (ops/norms.py::layer_norm
// then ops/rope.py::apply_rotary_emb, the plain version in
// kernels/qk_norm_rope.py) ran as about twenty elementwise and reduction
// passes over q and k.  The kernel runs on the inference path only (no
// gradient needed); the trainers keep the plain chain.
//
// Per row of 64 channels, the arithmetic is fp32 throughout: the mean, then
// the variance of the centred values (as layer_norm takes them), rstd =
// 1 / sqrt(var + eps), y = (x - mean) * rstd * w + b with the norm's [64]
// weight and bias, then, when tables are given, pair (2i, 2i+1) rotated by
// the token's cos/sin entry i of the [S, 32] fp32 tables (the text rows hold
// cos 1, sin 0: the identity, with no special case), and one rounding to the
// storage type at the end.  The plain chain rounds after each bf16/fp16 op
// of the apply; the kernel's result is the same or finer.
//
// Bound on an H100 SXM: memory.  At the 5b shape (B=2, S=19,126, H=48) q and
// k are 117.5 M values each: one read and one write of both is 0.94 GB a
// call, 0.28 ms at 3.35 TB/s; the tables are 4.9 MB.  The 2b shape (H=30):
// 0.59 GB, 0.18 ms.  About ten flops a value is nothing beside that.
//
// Design: a row is eight threads, each holding one 16-byte vector of eight
// channels, so the RoPE pairs stay inside one thread and the two reductions
// are three shuffles each among the row's eight lanes.  A work item is one
// token and kHeadsPerItem of its heads, in q and in k: its eight lanes load
// the token's cos/sin entries once into registers and reuse them over those
// 2 * kHeadsPerItem rows, taken kUnroll at a time, every load of a batch
// issued before its first row is used.  The norm params sit in shared memory
// as fp32, read there per row, which keeps a thread at 64 registers: four
// 256-thread blocks an SM.  On the H100 (a sweep not kept in the repo, at
// the 5b shape) that occupancy mattered more than deeper batches: 8 or 16
// rows in flight at 90-124 registers ran 15-20% slower, the params in
// registers (spilling at 64) 37% slower; items of 4 heads beat 2, 8 and 16
// (0.327 ms against 0.346, 0.337 and 0.342; a contiguous copy of the same
// bytes by PyTorch took 0.316), and make some 14,000 short blocks, so the
// last wave leaves little of the card idle.  Loads and stores are whole
// 128-byte rows, neighbouring lanes on neighbouring addresses.

#include "hopper.cuh"

namespace {

using hopper::pack_x2;
using hopper::unpack_x2;

constexpr int kD = 64;
constexpr int kLanes = 8;  // threads a row, 8 channels (16 bytes of bf16 or fp16) each
constexpr int kThreads = 256;
constexpr int kItemsPerBlock = kThreads / kLanes;
constexpr int kHeadsPerItem = 4;
constexpr int kUnroll = 4;  // rows a thread loads before it uses the first
constexpr float kInvD = 1.0f / kD;
static_assert(kThreads == 4 * kD, "one thread a norm param");

struct Params {
  const void* src[2];    // q, k: [B, S, H, 64], element strides below, rows contiguous
  void* dst[2];          // [B, S, H, 64] contiguous
  long long sb[2], ss[2], sh[2];
  const void* norm[4];   // q weight, q bias, k weight, k bias: [64] each, in E
  const float* cos;      // [S, 32] fp32, or null: no rotation
  const float* sin;
  int seq, heads, chunks;  // chunks = ceil(heads / kHeadsPerItem)
  long long items;         // B * S * chunks
  float eps;
};

// the sum over the row's eight lanes (mask: those lanes)
__device__ __forceinline__ float row_sum(float v, unsigned mask) {
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1) v += __shfl_xor_sync(mask, v, off);
  return v;
}

template <typename E>
__global__ void __launch_bounds__(kThreads, 4) s2v_qk_norm_rope_kernel(const Params p) {
  __shared__ __align__(16) float norm[4][kD];
  {
    const int which = threadIdx.x / kD, c = threadIdx.x % kD;
    const void* src = which == 0 ? p.norm[0] : which == 1 ? p.norm[1] : which == 2 ? p.norm[2] : p.norm[3];
    norm[which][c] = unpack_x2<E>(static_cast<const uint16_t*>(src)[c]).x;
  }
  __syncthreads();
  const long long item = static_cast<long long>(blockIdx.x) * kItemsPerBlock + threadIdx.x / kLanes;
  if (item >= p.items) return;  // the whole row's lanes leave together
  const int lane = threadIdx.x % kLanes;
  const unsigned mask = 0xFFu << (threadIdx.x % 32 / kLanes * kLanes);
  const long long token = item / p.chunks;
  const int h0 = static_cast<int>(item % p.chunks) * kHeadsPerItem;
  const int nh = min(kHeadsPerItem, p.heads - h0);
  const long long b = token / p.seq, s = token % p.seq;

  const bool rope = p.cos != nullptr;
  float cs[4], sn[4];
  if (rope) {  // pairs 4 * lane .. 4 * lane + 3 of the token's entry
    const float4 c = __ldg(reinterpret_cast<const float4*>(p.cos + s * (kD / 2)) + lane);
    const float4 t = __ldg(reinterpret_cast<const float4*>(p.sin + s * (kD / 2)) + lane);
    cs[0] = c.x; cs[1] = c.y; cs[2] = c.z; cs[3] = c.w;
    sn[0] = t.x; sn[1] = t.y; sn[2] = t.z; sn[3] = t.w;
  }
  // q's and k's pointers apart, chosen by a select: an array indexed by the
  // row's runtime tensor would live in local memory
  const E* q_src = static_cast<const E*>(p.src[0]) + b * p.sb[0] + s * p.ss[0] + lane * 8;
  const E* k_src = static_cast<const E*>(p.src[1]) + b * p.sb[1] + s * p.ss[1] + lane * 8;
  E* q_dst = static_cast<E*>(p.dst[0]) + token * p.heads * kD + lane * 8;
  E* k_dst = static_cast<E*>(p.dst[1]) + token * p.heads * kD + lane * 8;
  const long long q_sh = p.sh[0], k_sh = p.sh[1];

  // rows 0 .. nh - 1 are q's heads h0 .., rows nh .. 2 nh - 1 k's
  const int rows = 2 * nh;
#pragma unroll 1
  for (int r0 = 0; r0 < rows; r0 += kUnroll) {
    uint4 raw[kUnroll];
#pragma unroll
    for (int r = 0; r < kUnroll; ++r) {
      const int row = r0 + r, which = row >= nh, h = h0 + row - which * nh;
      const E* src = which ? k_src + h * k_sh : q_src + h * q_sh;
      if (row < rows) raw[r] = __ldg(reinterpret_cast<const uint4*>(src));
    }
#pragma unroll
    for (int r = 0; r < kUnroll; ++r) {
      const int row = r0 + r, which = row >= nh, h = h0 + row - which * nh;
      if (row >= rows) continue;  // uniform over the row's lanes
      const uint32_t words[4] = {raw[r].x, raw[r].y, raw[r].z, raw[r].w};
      float x[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = unpack_x2<E>(words[i]);
        x[2 * i] = f.x;
        x[2 * i + 1] = f.y;
      }
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) sum += x[i];
      const float mean = row_sum(sum, mask) * kInvD;
      float sq = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        x[i] -= mean;
        sq += x[i] * x[i];
      }
      const float rstd = 1.0f / sqrtf(row_sum(sq, mask) * kInvD + p.eps);
      const float4* w = reinterpret_cast<const float4*>(norm[2 * which]) + 2 * lane;
      const float4* bias = reinterpret_cast<const float4*>(norm[2 * which + 1]) + 2 * lane;
      const float4 wa = w[0], wb = w[1], ba = bias[0], bb = bias[1];
      const float wv[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
      const float bv[8] = {ba.x, ba.y, ba.z, ba.w, bb.x, bb.y, bb.z, bb.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) x[i] = x[i] * rstd * wv[i] + bv[i];
      uint32_t out[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float even = x[2 * j], odd = x[2 * j + 1];
        if (rope) {
          const float e = even * cs[j] - odd * sn[j];
          odd = odd * cs[j] + even * sn[j];
          even = e;
        }
        out[j] = pack_x2<E>(even, odd);
      }
      E* dst = (which ? k_dst : q_dst) + h * kD;
      *reinterpret_cast<uint4*>(dst) = make_uint4(out[0], out[1], out[2], out[3]);
    }
  }
}

template <typename E>
int launch(const void* q, const void* k, void* q_out, void* k_out, const void* q_weight, const void* q_bias,
           const void* k_weight, const void* k_bias, const void* cos, const void* sin, int batch,
           int seq, int heads, long long q_sb, long long q_ss, long long q_sh, long long k_sb, long long k_ss,
           long long k_sh, float eps, void* stream) {
  Params p;
  p.src[0] = q;
  p.src[1] = k;
  p.dst[0] = q_out;
  p.dst[1] = k_out;
  p.sb[0] = q_sb; p.ss[0] = q_ss; p.sh[0] = q_sh;
  p.sb[1] = k_sb; p.ss[1] = k_ss; p.sh[1] = k_sh;
  p.norm[0] = q_weight;
  p.norm[1] = q_bias;
  p.norm[2] = k_weight;
  p.norm[3] = k_bias;
  p.cos = static_cast<const float*>(cos);
  p.sin = static_cast<const float*>(sin);
  p.seq = seq;
  p.heads = heads;
  p.chunks = (heads + kHeadsPerItem - 1) / kHeadsPerItem;
  p.items = static_cast<long long>(batch) * seq * p.chunks;
  p.eps = eps;
  if (p.items == 0) return 0;
  const long long blocks = (p.items + kItemsPerBlock - 1) / kItemsPerBlock;
  s2v_qk_norm_rope_kernel<E><<<static_cast<unsigned>(blocks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define S2V_QK_NORM_ROPE_ARGS                                                                              \
  const void *q, const void *k, void *q_out, void *k_out, const void *q_weight, const void *q_bias,     \
      const void *k_weight, const void *k_bias, const void *cos, const void *sin,                       \
      int batch, int seq, int heads, long long q_sb, long long q_ss, long long q_sh, long long k_sb,    \
      long long k_ss, long long k_sh, float eps, void *stream

#define S2V_QK_NORM_ROPE_CALL                                                                              \
  q, k, q_out, k_out, q_weight, q_bias, k_weight, k_bias, cos, sin, batch, seq, heads, q_sb,             \
      q_ss, q_sh, k_sb, k_ss, k_sh, eps, stream

// q, k bf16 [B, S, H, 64] with element strides (rows contiguous, strides and
// base 16-byte aligned); q_out, k_out [B, S, H, 64] contiguous; the four norm
// params [64] bf16 contiguous; cos, sin [S, 32] fp32 contiguous and 16-byte
// aligned, or both null.  Returns a cudaError_t.
extern "C" int s2v_qk_norm_rope(S2V_QK_NORM_ROPE_ARGS) {
  return launch<__nv_bfloat16>(S2V_QK_NORM_ROPE_CALL);
}

// The same with q, k and the params fp16.
extern "C" int s2v_qk_norm_rope_f16(S2V_QK_NORM_ROPE_ARGS) { return launch<__half>(S2V_QK_NORM_ROPE_CALL); }
