// fp32 building blocks of the port's fp32 attention kernels
// (attention_f32.cu: B1, B4 and B6 in fp32; attention_f32_bwd.cu: B2, B5
// and B7 in fp32).
//
// Every product runs on the tensor cores as 3xTF32: an fp32 value x is split
// into big = tf32(x) and small = tf32(x - big) (round to nearest, ties away
// from zero, on the fp32 bits), and a*b is taken as
// small_a*big_b + big_a*small_b + big_a*big_b with fp32 accumulation, which
// keeps about fp32's precision where one TF32 pass keeps about three decimal
// digits.  The products are mma.sync.aligned.m16n8k8 (tf32 in, fp32 out),
// whose fragments the threads load from shared memory themselves: tf32
// wgmma reads K-major operands only, and P.V and the backward's dS.K,
// P^T.dO, dS^T.q would need transposed copies; mma.sync's B fragment is
// read by each thread wherever it lies.
//
// Fragments of m16n8k8 (g = lane / 4, t = lane % 4):
//   A (16 x 8, row-major): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
//   B (8 x 8, K x N):      b0 (t, g), b1 (t + 4, g)
//   C (16 x 8):            c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)
// An accumulator is reused as the A operand of the next product without
// moving data between threads by permuting that product's reduction index:
// A column t is the accumulator's column 2t and A column t + 4 its column
// 2t + 1, so a = {c0, c2, c1, c3}, and B's rows are read in the same order,
// b0 = row 2t, b1 = row 2t + 1 of the operand in shared memory.
//
// The tensor cores' fp32 accumulation truncates rather than rounds, so a sum
// kept in an accumulator across many tiles drifts (1e-4 relative after 299
// key tiles of the main shape, where the output is ~138x smaller than the sum
// of its terms' sizes): every product over a streamed tile starts from a
// zero accumulator and is added to the running sum with fp32 adds.
//
// Tiles sit in shared memory as [rows][64] fp32 with a pitch of 68 floats
// (272 bytes, a multiple of 16 for cp.async): every fragment read above hits
// 32 distinct banks.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace f32attn {

constexpr int kD = 64;           // head dim
constexpr int kPitch = kD + 4;   // floats per shared-memory row
constexpr int kThreads = 128;    // four warps, 16 rows each
constexpr int kRows = 64;        // rows of a block's resident tile and of each streamed tile
constexpr int kTileFloats = kRows * kPitch;
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

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a*b as 3xTF32, the small terms first
__device__ __forceinline__ void mma_3x(float (&c)[4], const uint32_t (&ab)[4], const uint32_t (&as)[4],
                                       const uint32_t (&bb)[2], const uint32_t (&bs)[2]) {
  mma_tf32(c, as, bb);
  mma_tf32(c, ab, bs);
  mma_tf32(c, ab, bb);
}

// A fragment of rows [0, 16) and columns [k0, k0 + 8) of a shared tile
__device__ __forceinline__ void load_a(const float* tile, int k0, int g, int t, uint32_t (&big)[4],
                                       uint32_t (&small)[4]) {
  split(tile[g * kPitch + k0 + t], big[0], small[0]);
  split(tile[(g + 8) * kPitch + k0 + t], big[1], small[1]);
  split(tile[g * kPitch + k0 + t + 4], big[2], small[2]);
  split(tile[(g + 8) * kPitch + k0 + t + 4], big[3], small[3]);
}

// A fragment from an accumulator (the permuted reduction index)
__device__ __forceinline__ void acc_as_a(const float (&c)[4], uint32_t (&big)[4], uint32_t (&small)[4]) {
  split(c[0], big[0], small[0]);
  split(c[2], big[1], small[1]);
  split(c[1], big[2], small[2]);
  split(c[3], big[3], small[3]);
}

// B fragment with the reduction over the tile's columns: B[k][n] = tile[n0 + n][k0 + k]
__device__ __forceinline__ void load_b_rows(const float* tile, int n0, int k0, int g, int t, uint32_t (&big)[2],
                                            uint32_t (&small)[2]) {
  split(tile[(n0 + g) * kPitch + k0 + t], big[0], small[0]);
  split(tile[(n0 + g) * kPitch + k0 + t + 4], big[1], small[1]);
}

// B fragment with the reduction over the tile's rows, in the permuted order of
// acc_as_a: B[t][n] = tile[k0 + 2t][n0 + n], B[t + 4][n] = tile[k0 + 2t + 1][n0 + n]
__device__ __forceinline__ void load_b_cols(const float* tile, int k0, int n0, int g, int t, uint32_t (&big)[2],
                                            uint32_t (&small)[2]) {
  split(tile[(k0 + 2 * t) * kPitch + n0 + g], big[0], small[0]);
  split(tile[(k0 + 2 * t + 1) * kPitch + n0 + g], big[1], small[1]);
}

// S[16 x 64] (+)= X[16 rows of x_tile] . Y[64 rows of y_tile]^T over d
__device__ __forceinline__ void product_rows(float (&s)[8][4], const float* x_tile, const float* y_tile, int g,
                                             int t) {
#pragma unroll
  for (int kk = 0; kk < kD / 8; ++kk) {
    uint32_t ab[4], as[4];
    load_a(x_tile, kk * 8, g, t, ab, as);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      uint32_t bb[2], bs[2];
      load_b_rows(y_tile, n * 8, kk * 8, g, t, bb, bs);
      mma_3x(s[n], ab, as, bb, bs);
    }
  }
}

// O[16 x 64] += P[16 x 64 (accumulator)] . Y[64 rows of y_tile]
__device__ __forceinline__ void product_acc(float (&o)[8][4], const float (&p)[8][4], const float* y_tile, int g,
                                            int t) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    uint32_t ab[4], as[4];
    acc_as_a(p[kk], ab, as);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      uint32_t bb[2], bs[2];
      load_b_cols(y_tile, kk * 8, n * 8, g, t, bb, bs);
      mma_3x(o[n], ab, as, bb, bs);
    }
  }
}

__device__ __forceinline__ void zero(float (&x)[8][4]) {
#pragma unroll
  for (int n = 0; n < 8; ++n) x[n][0] = x[n][1] = x[n][2] = x[n][3] = 0.f;
}

__device__ __forceinline__ void add(float (&x)[8][4], const float (&y)[8][4]) {
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[n][e] += y[n][e];
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// cp.async of rows [r0, r0 + kRows) of one (b, h) plane (`base` at row 0,
// `ss` floats between rows) into a shared tile; rows at or past row_end are
// zero-filled
__device__ __forceinline__ void load_tile(float* tile, const float* base, long long ss, int r0, int row_end,
                                          int tid) {
  for (int i = tid; i < kRows * (kD / 4); i += kThreads) {
    const int r = i >> 4, c = (i & 15) * 4;
    const bool ok = r0 + r < row_end;
    cp_async16(tile + r * kPitch + c, ok ? base + (long long)(r0 + r) * ss + c : base, ok);
  }
}

// store rows g and g + 8 of a [16 x 64] accumulator times `mul` into a
// [B, S, H, 64] plane (`base` at the warp's row 0), rows below `valid`
__device__ __forceinline__ void store_rows(float* base, long long ss, const float (&x)[8][4], float mul0,
                                           float mul1, int g, int t, int valid) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = g + 8 * r;
    if (row >= valid) continue;
    const float mul = r ? mul1 : mul0;
    float* dst = base + (long long)row * ss;
#pragma unroll
    for (int n = 0; n < 8; ++n)
      *reinterpret_cast<float2*>(dst + n * 8 + 2 * t) = make_float2(x[n][2 * r] * mul, x[n][2 * r + 1] * mul);
  }
}

// The band of a windowed call (band.cuh's key walk), or none
struct Band {
  int banded;  // 0: one key range [0, skv) for every query
  int G, tpf, n_frames, span, window;
  int frame_offset, local_frames;  // the query rows: frames frame_offset .. of tpf rows each
};

}  // namespace f32attn
