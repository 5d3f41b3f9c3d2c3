// Hopper (sm_90a) building blocks shared by the port's attention kernels.
//
// Raw PTX, no library: TMA tensor maps over the port's strided [B, S, H, 64]
// bf16 and int8 layouts (host), mbarrier rings, wgmma shared-memory
// descriptors for the 128-byte- (bf16) and 64-byte-swizzled (int8) tiles TMA
// writes, the m64nNk16 bf16 -> fp32 wgmma with A from registers or shared
// memory, the m64n128k32 s8 -> s32 wgmma from shared memory, and setmaxnreg
// for warp-specialised blocks.
//
// Layout facts the kernels rely on:
//  * d = 64 in bf16 is one 128-byte row, exactly one 128B swizzle atom wide.
//    TMA with CU_TENSOR_MAP_SWIZZLE_128B stores row r's 16-byte chunk c at
//    r * 128 + ((c ^ (r % 8)) * 16) inside a 1024-byte-aligned tile, which
//    is the layout a wgmma descriptor with swizzle mode 1 reads.
//  * d = 64 in int8 is one 64-byte row, one 64B swizzle atom wide.  TMA with
//    CU_TENSOR_MAP_SWIZZLE_64B stores row r's 16-byte chunk c at
//    r * 64 + ((c ^ ((r / 2) % 4)) * 16) inside a 512-byte-aligned tile,
//    the layout a descriptor with swizzle mode 2 reads; 8-row groups are 512
//    bytes apart (SBO) and the k32 step of an s8 wgmma advances the start
//    address by 32 bytes.  8-bit wgmma operands are K-major only, which q
//    [row, d] and K [key, d] both are.
//  * A tile [rows][64] used as B of D = A * B with the reduction over d
//    ("K-major", e.g. K in q.k^T): rows are B's N; 8-row groups are 1024
//    bytes apart (SBO); the k16 step advances the start address by 32 bytes.
//  * A tile [rows][64] used as B with the reduction over its rows
//    ("MN-major", e.g. V in P.V): rows are B's K, d is N; wgmma reads it
//    with the transpose bit; 8-row groups 1024 bytes apart (SBO); the k16
//    step advances the start address by 16 rows = 2048 bytes.
//  * Accumulator of m64nNk16 (fp32, N/2 registers a thread): warp w of the
//    warpgroup holds rows 16w + g and 16w + g + 8 (g = lane / 4); register
//    4j + e holds column 8j + 2(lane % 4) + (e & 1), row + 8 when e >= 2.
//    The A fragment from registers (4 x bf16x2 per k16 step) uses the same
//    rows: {row g, cols 2t..2t+1}, {row g+8, same}, {row g, cols 2t+8..},
//    {row g+8, cols 2t+8..}, so an accumulator re-packs into an A operand
//    without moving data between threads.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums only: the encoder comes through the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

// ---------------------------------------------------------------- host side

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// Error codes the C entry points return beside cudaError_t values.
constexpr int kErrNoEncoder = 10000;        // cuTensorMapEncodeTiled not found in libcuda
constexpr int kErrEncodeBase = 20000;       // + CUresult of a refused tensor map

inline EncodeTiledFn tensor_map_encoder() {
  static EncodeTiledFn encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    encode = reinterpret_cast<EncodeTiledFn>(fn);
  }
  return encode;
}

// A TMA map over a [B, S, H, 64] tensor of `elem_bytes`-byte elements with
// element strides (sb, ss, sh), seen as the 4-D tensor (d, S, H, B); the box
// is (64, box_rows, 1, 1), so one load brings box_rows consecutive rows of one
// (b, h), swizzled as `swizzle` says.  Rows past S are zero-filled by the TMA
// unit.  Returns 0 or an error code.
inline int make_bshd_map_typed(CUtensorMap* map, const void* base, CUtensorMapDataType dtype, int elem_bytes,
                               CUtensorMapSwizzle swizzle, int batch, int seq, int heads, long long sb, long long ss,
                               long long sh, int box_rows) {
  const EncodeTiledFn encode = tensor_map_encoder();
  if (encode == nullptr) return kErrNoEncoder;
  // The encoder needs a current context on the calling thread, and a thread
  // that has made no runtime call yet (PyTorch's autograd worker, when a
  // backward starts with this kernel) has none: cudaSetDevice binds the
  // current device's primary context.
  int device = 0;
  cudaError_t bound = cudaGetDevice(&device);
  if (bound == cudaSuccess) bound = cudaSetDevice(device);
  if (bound != cudaSuccess) return static_cast<int>(bound);
  // a dimension of size 1 is only ever at coordinate 0: any legal stride will do
  auto bytes = [elem_bytes](long long stride, int size) -> cuuint64_t {
    return size == 1 ? cuuint64_t(128) : cuuint64_t(stride) * cuuint64_t(elem_bytes);
  };
  const cuuint64_t dims[4] = {64, cuuint64_t(seq), cuuint64_t(heads), cuuint64_t(batch)};
  const cuuint64_t strides[3] = {bytes(ss, seq), bytes(sh, heads), bytes(sb, batch)};
  const cuuint32_t box[4] = {64, cuuint32_t(box_rows), 1, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, dtype, 4, const_cast<void*>(base), dims, strides, box, elem_strides,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrEncodeBase + int(r);
}

// bf16 [B, S, H, 64]: a row is 128 bytes, one 128B swizzle atom
inline int make_bshd_map(CUtensorMap* map, const void* base, int batch, int seq, int heads, long long sb,
                         long long ss, long long sh, int box_rows) {
  return make_bshd_map_typed(map, base, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, CU_TENSOR_MAP_SWIZZLE_128B, batch, seq,
                             heads, sb, ss, sh, box_rows);
}

// int8 [B, S, H, 64]: a row is 64 bytes, one 64B swizzle atom (strides in
// elements, which are bytes here)
inline int make_bshd_map_s8(CUtensorMap* map, const void* base, int batch, int seq, int heads, long long sb,
                            long long ss, long long sh, int box_rows) {
  return make_bshd_map_typed(map, base, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, CU_TENSOR_MAP_SWIZZLE_64B, batch, seq,
                             heads, sb, ss, sh, box_rows);
}

// -------------------------------------------------------------- device side

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The dynamic shared-memory base rounded up to 1024 bytes (the 128B swizzle's
// repeat); kernels ask for 1024 bytes more than they use.
__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  const uint32_t a = smem_u32(p);
  return p + (((a + 1023u) & ~1023u) - a);
}

// mbarriers ----------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

// makes the initialised barriers visible to the async (TMA) proxy; then __syncthreads
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// one arrival that also announces the bytes the phase's TMA copies will bring
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t addr, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(addr), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait until the phase of parity `parity` has completed.  A wait that lasts
// ~2^33 cycles (seconds) can only be a protocol fault: trap, so the launch
// fails with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  if (mbar_try_wait(addr, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(addr, parity)) {
    if (clock64() - t0 > (1ll << 33)) __trap();
  }
}

// TMA and bulk copies ------------------------------------------------------

__device__ __forceinline__ void prefetch_tensor_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// rows [row, row + box_rows) of head h, batch b, all 64 columns
__device__ __forceinline__ void tma_load_rows(void* dst, const CUtensorMap* map, uint64_t* bar, int row, int h,
                                              int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], "
      "[%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(0), "r"(row), "r"(h), "r"(b)
      : "memory");
}

// a contiguous copy of `bytes` (a multiple of 16, 16-byte aligned both ends)
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes), "r"(smem_u32(bar))
               : "memory");
}

// wgmma ----------------------------------------------------------------------

// Descriptor of a 128B-swizzled operand tile in shared memory (swizzle mode 1
// in bits 62-63; start, leading and stride byte offsets in 16-byte units).
__device__ __forceinline__ uint64_t desc_sw128(const void* tile, uint32_t lbo_bytes, uint32_t sbo_bytes) {
  const uint32_t addr = smem_u32(tile);
  return uint64_t((addr >> 4) & 0x3FFF) | (uint64_t((lbo_bytes >> 4) & 0x3FFF) << 16) |
         (uint64_t((sbo_bytes >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// A or B = tile[rows][64] with the reduction over d (K-major); k16 step kk of 4
__device__ __forceinline__ uint64_t desc_kmajor(const __nv_bfloat16* tile, int kk) {
  return desc_sw128(tile + kk * 16, 16, 1024);
}

// B = tile[rows][64] with the reduction over rows (MN-major, transposed); k16 step kk
__device__ __forceinline__ uint64_t desc_mnmajor(const __nv_bfloat16* tile, int kk) {
  return desc_sw128(tile + kk * 16 * 64, 16, 1024);
}

// Descriptor of a 64B-swizzled operand tile (swizzle mode 2 in bits 62-63):
// an int8 [rows][64] tile, K-major, 8-row groups 512 bytes apart (SBO); the
// swizzle repeats every 512 bytes, so tiles start on 512-byte boundaries.
__device__ __forceinline__ uint64_t desc_sw64(const void* tile, uint32_t sbo_bytes) {
  const uint32_t addr = smem_u32(tile);
  return uint64_t((addr >> 4) & 0x3FFF) | (uint64_t(1) << 16) | (uint64_t((sbo_bytes >> 4) & 0x3FFF) << 32) |
         (2ull << 62);
}

// A or B = int8 tile[rows][64] with the reduction over d (K-major); k32 step kk of 2
__device__ __forceinline__ uint64_t desc_kmajor_s8(const int8_t* tile, int kk) {
  return desc_sw64(tile + kk * 32, 512);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }

__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of registers that an
// in-flight wgmma owns across the fence/commit/wait instructions.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// the s32 accumulator of an integer wgmma (the f32 fragment layout)
template <int N>
__device__ __forceinline__ void fence_regs(int (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
  }
}

// register budgets of warp-specialised blocks (whole warpgroups at a time)
template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// register fragments ------------------------------------------------------

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The A fragments (4 k16 steps over d = 64) of this thread's two rows of a
// [S, 64] bf16 matrix at `base` with row stride `ss` elements; rows at or
// past `rows` read as zeros.
__device__ __forceinline__ void load_a_rows(uint32_t (&a)[4][4], const __nv_bfloat16* base, long long ss, int row0,
                                            int rows, int t) {
  const int row1 = row0 + 8;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int c = kk * 16 + t * 2;
    a[kk][0] = row0 < rows ? *reinterpret_cast<const uint32_t*>(base + row0 * ss + c) : 0u;
    a[kk][1] = row1 < rows ? *reinterpret_cast<const uint32_t*>(base + row1 * ss + c) : 0u;
    a[kk][2] = row0 < rows ? *reinterpret_cast<const uint32_t*>(base + row0 * ss + c + 8) : 0u;
    a[kk][3] = row1 < rows ? *reinterpret_cast<const uint32_t*>(base + row1 * ss + c + 8) : 0u;
  }
}

// An m64nNk16 accumulator's k16 chunk kc re-packed as a bf16 A fragment.
template <int NACC>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&acc)[NACC], int kc) {
  a[0] = pack_bf16x2(acc[8 * kc + 0], acc[8 * kc + 1]);
  a[1] = pack_bf16x2(acc[8 * kc + 2], acc[8 * kc + 3]);
  a[2] = pack_bf16x2(acc[8 * kc + 4], acc[8 * kc + 5]);
  a[3] = pack_bf16x2(acc[8 * kc + 6], acc[8 * kc + 7]);
}

// Writes this thread's share of a 64-column fp32 accumulator (32 registers)
// scaled by `scale` as bf16 rows of a [S, 64] matrix; rows past `rows` skipped.
__device__ __forceinline__ void store_rows(__nv_bfloat16* base, long long ss, int row0, int rows,
                                           const float (&acc)[32], float scale0, float scale1, int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= rows) continue;
    const float s = r == 0 ? scale0 : scale1;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      *reinterpret_cast<uint32_t*>(base + row * ss + j * 8 + t * 2) =
          pack_bf16x2(acc[4 * j + 2 * r] * s, acc[4 * j + 2 * r + 1] * s);
    }
  }
}

// The m64nNk16 bf16 -> fp32 products, A from registers (RS) or from a
// K-major shared-memory tile (SS), B from shared memory (TRANS_B = 1: B is
// MN-major).  `accumulate` = 0 overwrites D.
// D[64 x 64] (+)= A[64 x 16] (bf16 registers) * B[16 x 64] (shared memory, descriptor)
template <int TRANS_B>
__device__ __forceinline__ void mma_m64n64k16_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b,
                                                 int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate), "n"(TRANS_B));
}

// D[64 x 128] (+)= A[64 x 16] (bf16 registers) * B[16 x 128] (shared memory, descriptor)
template <int TRANS_B>
__device__ __forceinline__ void mma_m64n128k16_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t desc_b,
                                                 int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate), "n"(TRANS_B));
}

// D[64 x 64] (+)= A[64 x 16] * B[16 x 64], both from shared memory (descriptors; A K-major)
template <int TRANS_B>
__device__ __forceinline__ void mma_m64n64k16_ss(float (&d)[32], uint64_t desc_a, uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(TRANS_B));
}

// D[64 x 128] (+)= A[64 x 16] * B[16 x 128], both from shared memory (descriptors; A K-major)
template <int TRANS_B>
__device__ __forceinline__ void mma_m64n128k16_ss(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                                  int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(TRANS_B));
}

// D[64 x 128] (+)= A[64 x 32] * B[32 x 128], int8 x int8 -> int32, both
// from K-major 64B-swizzled shared-memory tiles (descriptors).  The integer
// form takes no negate or transpose immediates: 8-bit operands are K-major
// only.  The s32 accumulator has the f32 fragment layout; sums are exact
// (no .satfinite needed while |D| < 2^31).
__device__ __forceinline__ void mma_m64n128k32_s8_ss(int (&d)[64], uint64_t desc_a, uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

}  // namespace hopper
