// The adaLN-Zero LayerNorms, modulation and stream join of the DiT's blocks
// in one pass, for Hopper (sm_90a): up to three token streams, bf16 or fp16
// [B, L_k, D] (element strides: the outputs of the previous gated add), in
// the joined order text, ref, video -> one [B, L_0 + L_1 + L_2, D]
// contiguous output in the same type, each row LayerNormed over D and
// modulated by its stream's and batch row's (shift, scale).
//
// Replaces no TPU kernel: the JAX package leaves this chain to XLA, which
// fuses it.  In PyTorch the chain (ops/norms.py::layer_norm on each stream,
// the modulation's multiply and add, torch.cat into the joint sequence; the
// plain version in kernels/adaln.py) ran as some ten elementwise and
// reduction passes over every value.  The kernel runs on the inference path
// only (no gradient needed); the trainers keep the plain chain.  The output
// AdaLayerNorm (ops/adaln.py::ada_layer_norm_out) calls it with one stream.
//
// Per row of D channels, the arithmetic is fp32 throughout: the mean, then
// the variance of the centred values (two passes over the row held in
// registers, as layer_norm takes it; no E[x^2] - mean^2), rstd =
// 1 / sqrt(var + eps), y = (x - mean) * rstd * w + b with the norm's [D]
// weight and bias, out = y * (1 + scale) + shift with the fp32 [D] shift
// and scale of the row's stream and batch row, and one rounding to the
// storage type at the end.  The plain chain rounds after each bf16/fp16 op
// of the apply; the kernel's result is the same or finer.
//
// Bound on an H100 SXM: memory.  At the 5b shape (B=2, 226 + 1,350 +
// 17,550 tokens, D=3,072) one read of the streams and one write of the
// joined rows is 0.470 GB a call, 0.140 ms at 3.35 TB/s; the 2b shape
// (D=1,920, fp16) 0.294 GB, 0.088 ms; the 1.5 shape (49,186 tokens) 1.209
// GB, 0.361 ms.  The [B, 6D] fp32 modulation (147 KB) and the norm params
// stay in L1 and L2; some ten flops a value are nothing beside the bytes.
//
// Design: a row is one warp, each lane holding up to kVec 16-byte vectors of
// eight channels (vector i * 32 + lane: neighbouring lanes on neighbouring
// addresses), all loaded before the first is used and kept packed in
// registers through both statistics and the apply, so each value is read
// once and written once; the sums are shuffles within the warp, and no
// block needs a barrier.  The norm params (in the storage type) and the
// fp32 shift and scale rows are read in the apply through the read-only
// path, from L1.  Rows of every stream and batch row share the grid, eight
// to a 256-thread block, in the joined order; offsets are 64-bit (the 1.5
// output is 302 M values).  On the H100 (a sweep not kept in the repo, CUDA
// events, 5b / 2b / 1.5 shapes; a contiguous copy of the same bytes by
// PyTorch 0.159 / 0.103-0.109 / 0.400 ms): this shape 0.176-0.179 / 0.116-
// 0.117 / 0.419-0.422 ms, 76-80% / 75-76% / 86% of the bound.  Half-warp
// rows ran 0.209-0.371 / 0.123-0.134 / 0.480-0.845 ms, 128- and 512-thread
// blocks within 1-7% of 256; the norm params as fp32 in shared memory
// (filled by each block) 2-10% slower; 8-byte accesses (four channels, so
// the fp32 rows' 16-byte reads fall on neighbouring addresses too) 7-15%
// slower at D = 3,072 and within 3% at 1,920; loads that skip L1 or evict
// first, and evict-first stores, moved the three shapes by -3% to +5%, no
// way in all three, and were left out; a grid of as few warps as give every
// resident warp the same count of rows (so the last of the 9-12 waves is
// not nearly empty), each looping over its rows, 6-8% slower.  Between
// calls (machines) this shape read 0.175-0.185 / 0.116-0.124 / 0.416-0.426.

#include "hopper.cuh"

// The call as the wrapper fills it (kernels/adaln.py::_Args mirrors it); outside the
// anonymous namespace, so the C entry points that take it keep external linkage.
struct S2vAdalnArgs {
  const void* src[3];     // text, ref, video: [B, len[k], D] of E, strides sb, ss; rows contiguous
  const float* shift[3];  // [B, D] fp32 rows, mb_shift[k] floats apart
  const float* scale[3];
  long long sb[3], ss[3], mb_shift[3], mb_scale[3];
  int len[3];
  void* dst;              // [B, len[0] + len[1] + len[2], D] of E, contiguous
  const void* weight;     // [D] of E
  const void* bias;
  int batch, dim;
  float eps;
};

namespace {

using hopper::pack_x2;
using hopper::unpack_x2;

constexpr int kStreams = 3;

struct Params {
  const void* src[kStreams];
  const float* shift[kStreams];
  const float* scale[kStreams];
  long long sb[kStreams], ss[kStreams], mb_shift[kStreams], mb_scale[kStreams];
  void* dst;
  const void* weight;
  const void* bias;
  long long rows;           // B * joint
  int start1, start2;       // the first joined row of ref, of video
  int joint, dim;           // joint = T + R + V
  float eps, inv_dim;
};

constexpr int kLanes = 32;  // a row is one warp
constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / kLanes;

// the sum over the warp
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1) v += __shfl_xor_sync(0xFFFFFFFFu, v, off);
  return v;
}

// field k of a stream array, chosen by selects: an array indexed by a runtime
// stream would be copied to local memory
#define S2V_PICK(a) (k == 0 ? (a)[0] : k == 1 ? (a)[1] : (a)[2])

template <typename E, int kVec>
__global__ void __launch_bounds__(kThreads) s2v_adaln_zero_kernel(const Params p) {
  const long long row = static_cast<long long>(blockIdx.x) * kRowsPerBlock + threadIdx.x / kLanes;
  if (row >= p.rows) return;  // the whole warp leaves together
  const int lane = threadIdx.x % kLanes;
  const int vecs = p.dim / 8;
  const uint4* weight = static_cast<const uint4*>(p.weight);
  const uint4* bias = static_cast<const uint4*>(p.bias);
  const long long b = row / p.joint;
  const int j = static_cast<int>(row - b * p.joint);
  const int k = j < p.start1 ? 0 : (j < p.start2 ? 1 : 2);
  const int local = j - (k == 0 ? 0 : (k == 1 ? p.start1 : p.start2));
  const uint4* src = reinterpret_cast<const uint4*>(static_cast<const E*>(S2V_PICK(p.src)) + b * S2V_PICK(p.sb) +
                                                    local * S2V_PICK(p.ss));
  const float4* shift = reinterpret_cast<const float4*>(S2V_PICK(p.shift) + b * S2V_PICK(p.mb_shift));
  const float4* scale = reinterpret_cast<const float4*>(S2V_PICK(p.scale) + b * S2V_PICK(p.mb_scale));
  uint4* dst = reinterpret_cast<uint4*>(static_cast<E*>(p.dst) + row * p.dim);

  uint4 raw[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    const int v = i * kLanes + lane;
    if (v < vecs) raw[i] = __ldg(src + v);
  }

  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    if (i * kLanes + lane >= vecs) continue;
    const uint32_t words[4] = {raw[i].x, raw[i].y, raw[i].z, raw[i].w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = unpack_x2<E>(words[e]);
      sum += f.x;
      sum += f.y;
    }
  }
  const float mean = row_sum(sum) * p.inv_dim;
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    if (i * kLanes + lane >= vecs) continue;
    const uint32_t words[4] = {raw[i].x, raw[i].y, raw[i].z, raw[i].w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = unpack_x2<E>(words[e]);
      const float dx = f.x - mean, dy = f.y - mean;
      sq += dx * dx;
      sq += dy * dy;
    }
  }
  const float rstd = 1.0f / sqrtf(row_sum(sq) * p.inv_dim + p.eps);

#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    const int v = i * kLanes + lane;
    if (v >= vecs) continue;
    const uint4 wr = __ldg(weight + v), br = __ldg(bias + v);
    const float4 sh0 = __ldg(shift + 2 * v), sh1 = __ldg(shift + 2 * v + 1);
    const float4 sc0 = __ldg(scale + 2 * v), sc1 = __ldg(scale + 2 * v + 1);
    const uint32_t words[4] = {raw[i].x, raw[i].y, raw[i].z, raw[i].w};
    const uint32_t ww[4] = {wr.x, wr.y, wr.z, wr.w}, bw[4] = {br.x, br.y, br.z, br.w};
    const float sh[8] = {sh0.x, sh0.y, sh0.z, sh0.w, sh1.x, sh1.y, sh1.z, sh1.w};
    const float sc[8] = {sc0.x, sc0.y, sc0.z, sc0.w, sc1.x, sc1.y, sc1.z, sc1.w};
    uint32_t out[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = unpack_x2<E>(words[e]), w = unpack_x2<E>(ww[e]), bb = unpack_x2<E>(bw[e]);
      const float y0 = (f.x - mean) * rstd * w.x + bb.x;
      const float y1 = (f.y - mean) * rstd * w.y + bb.y;
      out[e] = pack_x2<E>(y0 * (1.0f + sc[2 * e]) + sh[2 * e], y1 * (1.0f + sc[2 * e + 1]) + sh[2 * e + 1]);
    }
    dst[v] = make_uint4(out[0], out[1], out[2], out[3]);
  }
}

#undef S2V_PICK

template <typename E, int kVec>
int launch_rows(const Params& p, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((p.rows + kRowsPerBlock - 1) / kRowsPerBlock));
  s2v_adaln_zero_kernel<E, kVec><<<grid, kThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename E>
int launch(const S2vAdalnArgs* a, void* stream_ptr) {
  Params p;
  int joint = 0;
  for (int k = 0; k < kStreams; ++k) {
    p.src[k] = a->src[k];
    p.shift[k] = a->shift[k];
    p.scale[k] = a->scale[k];
    p.sb[k] = a->sb[k];
    p.ss[k] = a->ss[k];
    p.mb_shift[k] = a->mb_shift[k];
    p.mb_scale[k] = a->mb_scale[k];
    joint += a->len[k];
  }
  p.start1 = a->len[0];
  p.start2 = a->len[0] + a->len[1];
  p.joint = joint;
  p.dim = a->dim;
  p.rows = static_cast<long long>(a->batch) * joint;
  p.dst = a->dst;
  p.weight = a->weight;
  p.bias = a->bias;
  p.eps = a->eps;
  p.inv_dim = 1.0f / static_cast<float>(a->dim);
  if (a->dim % 8 != 0 || a->dim <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (p.rows == 0) return 0;
  // a row's vectors a lane, in buckets of 1,024 channels: 5b and 1.5 take 12, 2b 8
  const int per_lane = (a->dim / 8 + kLanes - 1) / kLanes;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (per_lane <= 4) return launch_rows<E, 4>(p, stream);
  if (per_lane <= 8) return launch_rows<E, 8>(p, stream);
  if (per_lane <= 12) return launch_rows<E, 12>(p, stream);
  if (per_lane <= 16) return launch_rows<E, 16>(p, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// bf16 streams, output and norm params (the layouts of S2vAdalnArgs above; every
// pointer and row stride 16-byte aligned, D a multiple of 8).  Returns a
// cudaError_t.
extern "C" int s2v_adaln_zero(const S2vAdalnArgs* args, void* stream) { return launch<__nv_bfloat16>(args, stream); }

// The same with fp16.
extern "C" int s2v_adaln_zero_f16(const S2vAdalnArgs* args, void* stream) { return launch<__half>(args, stream); }
