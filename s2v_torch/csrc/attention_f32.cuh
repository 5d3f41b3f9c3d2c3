// fp32 building blocks of the port's fp32 attention kernels
// (attention_f32.cu: B1, B4, B6 and B3's fp32 form; attention_f32_bwd.cu:
// B2, B5 and B7 in fp32).
//
// Every fp32 product runs on the tensor cores as 3xTF32: an fp32 value x is
// split into big = tf32(x) and small = tf32(x - big) (round to nearest, ties
// away from zero, on the fp32 bits), and a*b is taken as
// small_a*big_b + big_a*small_b + big_a*big_b with fp32 accumulation, which
// keeps about fp32's precision where one TF32 pass keeps about three decimal
// digits.  The products are wgmma m64nNk8 tf32 (hopper.cuh's layer: TMA,
// mbarriers, 128-byte-swizzle descriptors).
//
// Split once.  tf32 wgmma reads K-major operands only, from shared memory
// (and A also from registers), so a pre-pass writes each operand's PLANES
// once per call: its big and its small halves as fp32 tensors, row planes
// [2, B*H, S, 64] (big, then small) for the products that reduce over d
// (q.K^T, dO.V^T and their transposes), and transposed planes [2, B*H, 64,
// S_pad] for those that reduce over the sequence (P.V, dS.K, P^T.dO,
// dS^T.q).  TMA brings plane tiles into shared memory as two 32-float-wide
// 128B-swizzled halves (a half is one swizzle atom wide; a k8 step is 32
// bytes into it), which is the layout a K-major descriptor reads.  A
// block's resident q (or K in dk/dv) is read into registers once, already
// split.  Only P and dS, which the kernels make, are split where they are
// made (acc_to_a).
//
// Fragments (per warp of a warpgroup, g = lane / 4, t = lane % 4):
//   accumulator of m64nN: register 4j + e is row 16w + g (+ 8 when e >= 2),
//   column 8j + 2t + (e & 1);
//   A of m64nNk8 tf32 from registers: a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
//   a3 (g + 8, t + 4) of the k8 chunk.
// So an accumulator's chunk j becomes an A fragment by moving columns
// between the four threads of a row (two shuffles a value), after which
// every B operand is read in its natural order.
//
// The tensor cores' fp32 accumulation truncates rather than rounds, so a sum
// kept in an accumulator across many tiles drifts (1e-4 relative after 299
// key tiles of the main shape, where the output is ~138x smaller than the sum
// of its terms' sizes): every product over a streamed tile starts from a
// zero accumulator and is added to the running sum with fp32 adds.

#pragma once

#include "band.cuh"
#include "hopper.cuh"

#include <math.h>

namespace f32attn {

using namespace hopper;

constexpr int kD = 64;          // head dim
constexpr int kHalf = 32;       // floats of one 128B swizzle atom row: half a plane row
constexpr int kWgRows = 64;     // rows of one consumer warpgroup
constexpr int kConsumers = 2;   // consumer warpgroups a block
constexpr int kThreads = 128 * kConsumers;
constexpr int kBlockRows = kWgRows * kConsumers;  // rows a block owns (queries; keys in dk/dv)
constexpr float kNegInit = -1e30f;  // the running max before any key (as the plain versions)
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// tf32 rounding of the fp32 bits: round to nearest, ties away from zero
// (cvt.rna.tf32.f32), done on the integer bits so that the emulation in
// kernels/attention_f32.py rounds the same way
__device__ __forceinline__ float tf32_round(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xffffe000u);
}

__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  const float b = tf32_round(x);
  big = __float_as_uint(b);
  small = __float_as_uint(tf32_round(x - b));
}

// ------------------------------------------------------------------ wgmma

// D[64 x 64] (+)= A[64 x 8] (tf32, registers) * B[8 x 64] (tf32, K-major shared-memory tile)
__device__ __forceinline__ void wgmma_tf32_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b,
                                                int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]),
        "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
        "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

// D[64 x 32] (+)= A[64 x 8] (tf32, registers) * B[8 x 32] (tf32, K-major shared-memory tile)
__device__ __forceinline__ void wgmma_tf32_rs_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t desc_b,
                                                int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]),
        "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

// D[64 x 32] (+)= A[64 x 8] * B[8 x 32], tf32, both K-major shared-memory tiles
__device__ __forceinline__ void wgmma_tf32_ss_n32(float (&d)[16], uint64_t desc_a, uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]),
        "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// D[64 x 64] (+)= A[64 x 32] * B[32 x 64], int8 x int8 -> int32, both K-major 64B-swizzled tiles
__device__ __forceinline__ void wgmma_s8_ss_n64(int (&d)[32], uint64_t desc_a, uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]),
        "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]),
        "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// Descriptor of k8 step kk (0..7 over d = 64, or 0..3 over a 32-wide tile)
// of a K-major tile of `rows` rows stored as 32-float halves (each rows x 128
// bytes, 1024-aligned); `row0` selects a 64-row slab of a taller tile
__device__ __forceinline__ uint64_t desc_k8(const float* tile, int rows, int kk, int row0 = 0) {
  return desc_sw128(tile + (kk >> 2) * rows * kHalf + row0 * kHalf + (kk & 3) * 8, 16, 1024);
}

// ---------------------------------------------------------------- fragments

// The A fragment of an accumulator's chunk j (its registers c[0..3]:
// columns 2t, 2t + 1 of rows g, g + 8), split into big and small: columns t
// and t + 4 come from the row's threads t / 2 and t / 2 + 2.
__device__ __forceinline__ void acc_to_a(const float* c, uint32_t (&big)[4], uint32_t (&small)[4]) {
  const int lane = threadIdx.x & 31, t = lane & 3;
  const int src0 = (lane & ~3) | (t >> 1), src1 = src0 + 2;
  const bool odd = t & 1;
  float v[4];
#pragma unroll
  for (int r = 0; r < 2; ++r) {  // rows g (c0, c1) and g + 8 (c2, c3)
    const float x0 = __shfl_sync(0xffffffffu, c[2 * r], src0), x1 = __shfl_sync(0xffffffffu, c[2 * r + 1], src0);
    const float y0 = __shfl_sync(0xffffffffu, c[2 * r], src1), y1 = __shfl_sync(0xffffffffu, c[2 * r + 1], src1);
    v[r] = odd ? x1 : x0;      // a0 / a1: column t
    v[r + 2] = odd ? y1 : y0;  // a2 / a3: column t + 4
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) split(v[i], big[i], small[i]);
}

// The A fragments of this thread's rows g and g + 8 of a warp's 16 rows for
// all 8 k8 chunks of d, from a row plane's big and small halves (`big_rows`,
// `small_rows` at the warp's row 0, rows of 64 floats), read once into
// registers; rows at or past `valid` read as zeros.
__device__ __forceinline__ void load_a_planes(const float* big_rows, const float* small_rows, int valid,
                                              uint32_t (&big)[8][4], uint32_t (&small)[8][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = g + 8 * (i & 1), col = kk * 8 + t + 4 * (i >> 1);
      const bool ok = row < valid;
      big[kk][i] = ok ? __float_as_uint(big_rows[row * kD + col]) : 0u;
      small[kk][i] = ok ? __float_as_uint(small_rows[row * kD + col]) : 0u;
    }
}

// store rows g and g + 8 of a warp's [16 x 64] accumulator times `mul` into a
// [B, S, H, 64] fp32 tensor (`base` at the warp's row 0), rows below `valid`
__device__ __forceinline__ void store_acc_rows(float* base, long long ss, const float (&x)[32], float mul, int valid) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = g + 8 * r;
    if (row >= valid) continue;
    float* dst = base + (long long)row * ss;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<float2*>(dst + j * 8 + 2 * t) = make_float2(x[4 * j + 2 * r] * mul, x[4 * j + 2 * r + 1] * mul);
  }
}

// -------------------------------------------------------------------- TMA

// A TMA map over planes seen as the 3-D tensor (inner, rows, planes) of fp32,
// row pitch `inner` floats, box (32, box_rows, 1), 128B swizzle.  Row planes:
// inner = 64, rows = S; transposed planes: inner = S_pad, rows = 64.  Rows
// and columns past the tensor arrive as zeros.  Returns 0 or an error code.
inline int make_plane_map(CUtensorMap* map, const float* base, long long inner, long long rows, long long planes,
                          int box_rows) {
  const EncodeTiledFn encode = tensor_map_encoder();
  if (encode == nullptr) return kErrNoEncoder;
  int device = 0;
  cudaError_t bound = cudaGetDevice(&device);  // the encoder needs a current context (see hopper.cuh)
  if (bound == cudaSuccess) bound = cudaSetDevice(device);
  if (bound != cudaSuccess) return static_cast<int>(bound);
  const cuuint64_t dims[3] = {cuuint64_t(inner), cuuint64_t(rows), cuuint64_t(planes)};
  const cuuint64_t strides[2] = {cuuint64_t(inner) * 4, cuuint64_t(inner) * cuuint64_t(rows) * 4};
  const cuuint32_t box[3] = {cuuint32_t(kHalf), cuuint32_t(box_rows), 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(base), dims, strides, box,
                            elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrEncodeBase + int(r);
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], "
      "[%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// rows [r0, r0 + box rows) of plane `plane` of a row-plane map: both 32-float
// halves, the second `rows` x 32 floats after the first
__device__ __forceinline__ void load_row_tile(float* dst, const CUtensorMap* map, uint64_t* bar, int r0, int plane,
                                              int rows) {
  tma_load_3d(dst, map, bar, 0, r0, plane);
  tma_load_3d(dst + rows * kHalf, map, bar, kHalf, r0, plane);
}

// columns (sequence positions) [s0, s0 + 32 * halves) of plane `plane` of a
// transposed-plane map, all 64 rows, each 32-wide half after the last
__device__ __forceinline__ void load_cols_tile(float* dst, const CUtensorMap* map, uint64_t* bar, int s0, int plane,
                                               int halves) {
  for (int i = 0; i < halves; ++i) tma_load_3d(dst + i * kD * kHalf, map, bar, s0 + i * kHalf, 0, plane);
}

// ---------------------------------------------------------------- pre-pass

// The length of a transposed plane's rows: S rounded up to 4 (16-byte rows for TMA)
__host__ __device__ __forceinline__ long long pad_seq(long long s) { return (s + 3) / 4 * 4; }

// Row planes of a fp32 [B, S, H, 64] tensor (element strides, rows 16-byte
// aligned) into dst [2, B*H, S, 64]: one thread per row and 4 columns.
__global__ void __launch_bounds__(256) split_rows_kernel(const float* src, float* dst, int heads, int seq,
                                                         long long sb, long long ss, long long sh, int bh_total) {
  const long long i = blockIdx.x * 256LL + threadIdx.x;
  if (i >= (long long)seq * 16) return;
  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const int row = static_cast<int>(i >> 4), c = static_cast<int>(i & 15) * 4;
  const float4 x = *reinterpret_cast<const float4*>(src + b * sb + h * sh + row * ss + c);
  uint4 big, small;
  split(x.x, big.x, small.x);
  split(x.y, big.y, small.y);
  split(x.z, big.z, small.z);
  split(x.w, big.w, small.w);
  const long long at = ((long long)bh * seq + row) * kD + c;
  *reinterpret_cast<uint4*>(dst + at) = big;
  *reinterpret_cast<uint4*>(dst + (long long)bh_total * seq * kD + at) = small;
}

// Transposed planes into dst [2, B*H, 64, S_pad] (positions S .. S_pad - 1
// written as zeros): a block per 32 rows of one (b, h), through shared memory.
__global__ void __launch_bounds__(256) split_cols_kernel(const float* src, float* dst, int heads, int seq,
                                                         long long sb, long long ss, long long sh, int bh_total) {
  __shared__ float tile[32][kD + 1];
  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const int s0 = blockIdx.x * 32;
  const long long seq_pad = pad_seq(seq);
  for (int i = threadIdx.x; i < 32 * kD; i += 256) {
    const int r = i / kD, c = i % kD;
    tile[r][c] = s0 + r < seq ? src[b * sb + h * sh + (long long)(s0 + r) * ss + c] : 0.f;
  }
  __syncthreads();
  const int r = threadIdx.x & 31;
  if (s0 + r >= seq_pad) return;
  for (int c = threadIdx.x >> 5; c < kD; c += 8) {
    uint32_t big, small;
    split(tile[r][c], big, small);
    const long long at = ((long long)bh * kD + c) * seq_pad + s0 + r;
    dst[at] = __uint_as_float(big);
    dst[(long long)bh_total * kD * seq_pad + at] = __uint_as_float(small);
  }
}

inline int launch_split_rows(const float* src, float* dst, int batch, int heads, int seq, long long sb, long long ss,
                             long long sh, cudaStream_t stream) {
  if (seq == 0 || batch * heads == 0) return 0;
  const dim3 grid(static_cast<unsigned>((seq * 16LL + 255) / 256), batch * heads);
  split_rows_kernel<<<grid, 256, 0, stream>>>(src, dst, heads, seq, sb, ss, sh, batch * heads);
  return static_cast<int>(cudaGetLastError());
}

inline int launch_split_cols(const float* src, float* dst, int batch, int heads, int seq, long long sb, long long ss,
                             long long sh, cudaStream_t stream) {
  if (seq == 0 || batch * heads == 0) return 0;
  const dim3 grid(static_cast<unsigned>((pad_seq(seq) + 31) / 32), batch * heads);
  split_cols_kernel<<<grid, 256, 0, stream>>>(src, dst, heads, seq, sb, ss, sh, batch * heads);
  return static_cast<int>(cudaGetLastError());
}

// floats of row planes and of transposed planes of a [B, S, H, 64] tensor
inline long long row_planes(int bh, int seq) { return 2LL * bh * seq * kD; }
inline long long col_planes(int bh, int seq) { return 2LL * bh * kD * pad_seq(seq); }

// A transposed-plane tile's first sequence position is TMA's innermost
// coordinate, which must fall on a 16-byte boundary: every range of tiles
// starts at its first row rounded down to kAlign, and the rows before the
// range are masked like those past its end.
constexpr int kAlign = 4;

__host__ __device__ __forceinline__ int align_down(int x) { return x - x % kAlign; }

// band.cuh's key walk of one query frame (or the whole key range) with its
// window tiles starting at align_down(win_lo)
template <int TILE>
struct AlignedWalk {
  int end0, n_first, win_base, win_lo, win_hi, n_tiles;

  __device__ __forceinline__ explicit AlignedWalk(const band::KeyWalk& w)
      : end0(w.end0), n_first(w.n_first), win_base(align_down(w.win_lo)), win_lo(w.win_lo), win_hi(w.win_hi),
        n_tiles(w.n_tiles > w.n_first ? w.n_first + (w.win_hi - align_down(w.win_lo) + TILE - 1) / TILE
                                      : w.n_tiles) {}

  // tile j: its first key, and the keys [klo, kend) of its range
  __device__ __forceinline__ void tile(int j, int& kbase, int& klo, int& kend) const {
    if (j < n_first) {
      kbase = j * TILE;
      klo = 0;
      kend = end0;
    } else {
      kbase = win_base + (j - n_first) * TILE;
      klo = win_lo;
      kend = win_hi;
    }
  }
};

// the walk over keys [0, skv) of a call without a band
template <int TILE>
__device__ __forceinline__ band::KeyWalk full_walk(int skv) {
  band::KeyWalk w;
  w.end0 = skv;
  w.n_first = (skv + TILE - 1) / TILE;
  w.win_lo = w.win_hi = skv;
  w.n_tiles = w.n_first;
  return w;
}

// The band of a windowed call (band.cuh's key walk), or none
struct Band {
  int banded;  // 0: one key range [0, skv) for every query
  int G, tpf, n_frames, span, window;
  int frame_offset, local_frames;  // the query rows: frames frame_offset .. of tpf rows each
};

}  // namespace f32attn
