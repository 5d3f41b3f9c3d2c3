// Non-causal flash attention with an int8 q.k^T for Hopper (sm_90a): int8
// q and k, bf16 v, fp32 online softmax, bf16 out.
//
// Replaces the TPU kernel B3, s2v_tpu/ops/pallas/int8_attention.py::
// flash_attention_qk_int8 (_int8_kernel).  Same contract, not the Mosaic
// layout: the TPU pre-transposes K to [d, S], pads S to the key block, routes
// a -1e30 tail-mask row through the index map and appends a ones column to V
// for the row sums.  Here K stays [key, d] (already the column-major B
// operand of mma ... .row.col), the ragged key tail is a predicate on the
// logits (-inf: a zero-filled int8 key would give logit 0 and, when every
// real logit of a row is below about -40, pin the running max and underflow
// the real probabilities), and the row sums are kept in registers.
//
// Inputs come from the wrapper's pre-pass (s2v_torch/kernels/int8_attention.py):
// scale*q and k quantized with one scale per tensor, and dq = qs*ks as a
// one-element fp32 device tensor read here through a pointer, so no host
// sync is needed.  Logits are s = (q_i8 . k_i8) * dq, exact in int32.
//
// Bound on an H100 SXM at the main-path shape (B=2, H=48, S=19,126, d=64):
// q.k^T is 2*B*H*S^2*d = 4.5e12 int8 operations, 2.27 ms at 1,979 TOPS; P.V
// 4.5e12 bf16 operations, 4.55 ms at 989 TFLOP/s; 6.8 ms in all, against
// under 1 GB of q/k/v/o traffic (0.3 ms at 3.35 TB/s): compute-bound.
//
// Design (kernel B1's online mode with an int8 first product; wgmma, TMA and
// warp specialisation are later work):
//   * grid (ceil(Sq/128), B*H); 8 warps per block, 16 query rows per warp;
//   * K (int8) and V (bf16) tiles of 64 keys double-buffered in shared memory
//     with cp.async; K rows padded to 80 bytes and V rows to 72 elements, so
//     every fragment read is bank-conflict free;
//   * S = Q K^T with mma.sync m16n8k32 s8 x s8 -> s32 (two per n8 tile over
//     d = 64, against four bf16 m16n8k16 in B1); q fragments held in
//     registers for the whole key loop;
//   * the int32 logits converted exactly with an integer add and a float
//     subtract (exact_i2f), then scaled by dq * log2(e);
//   * online softmax in exp2; P re-packed in registers as the bf16 A
//     operand of P.V (mma.sync m16n8k16, fp32 accumulation); l == 0 gives a
//     zero row.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kD = 64;             // head dim (CogVideoX 2b and 5b)
constexpr int kBQ = 128;           // query rows per block
constexpr int kBK = 64;            // keys per tile
constexpr int kWarps = kBQ / 16;   // one m16 row slab per warp
constexpr int kThreads = kWarps * 32;
constexpr int kLdsK = kD + 16;     // padded int8 K row, in bytes
constexpr int kLdsV = kD + 8;      // padded bf16 V row, in elements
constexpr float kNegBig = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000u); }

struct Params {
  const int8_t* q;
  const int8_t* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  const float* dq;          // device scalar: qs * ks
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  int H, Sq, Skv;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; src_bytes == 0 zero-fills the destination.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const int src_bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// D = A * B + D, A 16x32 s8 (row), B 32x8 s8 (col), D s32.  Fragments (PTX
// ISA, mma.m16n8k32 with .s8): a[0] = A[g][4t..4t+3], a[1] = A[g+8][4t..],
// a[2] = A[g][16+4t..], a[3] = A[g+8][16+4t..]; b[0] = B[4t..4t+3][g],
// b[1] = B[16+4t..][g]; d[0..1] = D[g][2t, 2t+1], d[2..3] = D[g+8][2t, 2t+1]
// (g = lane / 4, t = lane % 4; four consecutive bytes per register, the
// lowest index in the lowest byte).
__device__ __forceinline__ void mma_s8_16832(int* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_bf16_16816(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// int32 -> fp32, exact for |x| < 2^22 (here |acc| <= 127^2 * 64 < 2^21): the
// bits of 1.5 * 2^23 plus x are the float 1.5 * 2^23 + x, so an integer add
// and a float subtract at full rate replace a quarter-rate I2F conversion
// (one per logit, as many as the softmax's exponentials).
__device__ __forceinline__ float exact_i2f(int x) {
  return __int_as_float(x + 0x4B400000) - 12582912.0f;
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t load_u32(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__global__ void __launch_bounds__(kThreads, 2) int8_fwd_kernel(const Params p) {
  __shared__ __align__(16) int8_t k_s[2][kBK * kLdsK];
  __shared__ __align__(16) __nv_bfloat16 v_s[2][kBK * kLdsV];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // fragment row group
  const int t4 = lane & 3;  // thread within the group
  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y % p.H;
  const int row0 = blockIdx.x * kBQ + warp * 16 + g;  // this thread's rows: row0, row0 + 8
  const int row1 = row0 + 8;

  const int8_t* qp = p.q + b * p.q_sb + h * p.q_sh;
  const int8_t* kp = p.k + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* vp = p.v + b * p.v_sb + h * p.v_sh;

  // A fragments of the warp's 16 query rows, all 64 dims (2 k32 chunks);
  // rows past Sq are zero and never written
  uint32_t qf[2][4];
#pragma unroll
  for (int kc = 0; kc < 2; ++kc) {
    const int c = kc * 32 + t4 * 4;
    qf[kc][0] = row0 < p.Sq ? load_u32(qp + row0 * p.q_ss + c) : 0u;
    qf[kc][1] = row1 < p.Sq ? load_u32(qp + row1 * p.q_ss + c) : 0u;
    qf[kc][2] = row0 < p.Sq ? load_u32(qp + row0 * p.q_ss + c + 16) : 0u;
    qf[kc][3] = row1 < p.Sq ? load_u32(qp + row1 * p.q_ss + c + 16) : 0u;
  }

  auto load_tile = [&](int tile, int buf) {
    const int kbase = tile * kBK;
    {
      // K: 64 rows of 64 bytes, one 16-byte chunk per thread
      const int r = tid >> 2;
      const int ch = (tid & 3) * 16;
      const int key = kbase + r;
      const bool ok = key < p.Skv;
      const long long kk = ok ? key : 0;
      cp_async16(&k_s[buf][r * kLdsK + ch], kp + kk * p.k_ss + ch, ok);
    }
#pragma unroll
    for (int i = tid; i < kBK * (kD / 8); i += kThreads) {
      // V: 64 rows of 64 bf16, two 16-byte chunks per thread
      const int r = i >> 3;
      const int ch = (i & 7) * 8;
      const int key = kbase + r;
      const bool ok = key < p.Skv;
      const long long kk = ok ? key : 0;
      cp_async16(&v_s[buf][r * kLdsV + ch], vp + kk * p.v_ss + ch, ok);
    }
  };

  float o_acc[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    o_acc[nt][0] = o_acc[nt][1] = o_acc[nt][2] = o_acc[nt][3] = 0.f;
  }
  float m_run[2] = {kNegBig, kNegBig};  // running max, log2 units
  float l_run[2] = {0.f, 0.f};          // this thread's share of the row sums
  const float dq_log2 = *p.dq * kLog2e;

  const int n_tiles = (p.Skv + kBK - 1) / kBK;
  load_tile(0, 0);
  cp_async_commit();

  for (int j = 0; j < n_tiles; ++j) {
    const int buf = j & 1;
    if (j + 1 < n_tiles) {
      load_tile(j + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // S = Q K^T in int32: 16 rows x 64 keys per warp, 8 n8 tiles of 2 k32 steps
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      int acc[4] = {0, 0, 0, 0};
#pragma unroll
      for (int kc = 0; kc < 2; ++kc) {
        const int8_t* kr = &k_s[buf][(nt * 8 + g) * kLdsK + kc * 32 + t4 * 4];
        const uint32_t bf[2] = {load_u32(kr), load_u32(kr + 16)};
        mma_s8_16832(acc, qf[kc], bf);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = exact_i2f(acc[e]) * dq_log2;
    }

    // keys past Skv (zero-filled int8 in the last tile) are excluded: -inf
    const int kbase = j * kBK;
    if (kbase + kBK > p.Skv) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = kbase + nt * 8 + t4 * 2 + (e & 1);
          if (key >= p.Skv) s[nt][e] = neg_inf();
        }
      }
    }

    // online softmax: every tile holds at least one real key, so the maxima are finite
    float mx0 = m_run[0], mx1 = m_run[1];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float a0 = fast_exp2(m_run[0] - mx0);
    const float a1 = fast_exp2(m_run[1] - mx1);
    m_run[0] = mx0;
    m_run[1] = mx1;
    l_run[0] *= a0;
    l_run[1] *= a1;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      o_acc[nt][0] *= a0;
      o_acc[nt][1] *= a0;
      o_acc[nt][2] *= a1;
      o_acc[nt][3] *= a1;
      s[nt][0] = fast_exp2(s[nt][0] - mx0);
      s[nt][1] = fast_exp2(s[nt][1] - mx0);
      s[nt][2] = fast_exp2(s[nt][2] - mx1);
      s[nt][3] = fast_exp2(s[nt][3] - mx1);
      l_run[0] += s[nt][0] + s[nt][1];
      l_run[1] += s[nt][2] + s[nt][3];
    }

    // O += P V: P re-packed from the S accumulator as bf16 A fragments.
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      const uint32_t pa[4] = {
          pack_bf16x2(s[2 * kc][0], s[2 * kc][1]),
          pack_bf16x2(s[2 * kc][2], s[2 * kc][3]),
          pack_bf16x2(s[2 * kc + 1][0], s[2 * kc + 1][1]),
          pack_bf16x2(s[2 * kc + 1][2], s[2 * kc + 1][3]),
      };
      const uint16_t* vr =
          reinterpret_cast<const uint16_t*>(&v_s[buf][(kc * 16 + t4 * 2) * kLdsV + g]);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const uint16_t* vc = vr + nt * 8;
        const uint32_t bf[2] = {
            uint32_t(vc[0]) | (uint32_t(vc[kLdsV]) << 16),
            uint32_t(vc[8 * kLdsV]) | (uint32_t(vc[9 * kLdsV]) << 16),
        };
        mma_bf16_16816(o_acc[nt], pa, bf);
      }
    }
    __syncthreads();  // the next iteration's copy overwrites this buffer
  }

  // full row sums: reduce over the four threads that share a row
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }

  __nv_bfloat16* op = p.o + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r == 0 ? row0 : row1;
    if (row >= p.Sq) continue;
    const float l = l_run[r];
    const float inv = l > 0.f ? 1.f / l : 0.f;  // l == 0 -> l = 1 over a zero accumulator
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const uint32_t packed = pack_bf16x2(o_acc[nt][2 * r] * inv, o_acc[nt][2 * r + 1] * inv);
      *reinterpret_cast<uint32_t*>(op + row * p.o_ss + nt * 8 + t4 * 2) = packed;
    }
  }
}

}  // namespace

extern "C" int s2v_int8_attention_fwd(
    const void* q, const void* k, const void* v, void* o, const void* dq,
    int batch, int heads, int sq, int skv,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    void* stream) {
  Params p;
  p.q = static_cast<const int8_t*>(q);
  p.k = static_cast<const int8_t*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.dq = static_cast<const float*>(dq);
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.o_sb = o_sb; p.o_ss = o_ss; p.o_sh = o_sh;
  p.H = heads;
  p.Sq = sq;
  p.Skv = skv;
  const dim3 grid((sq + kBQ - 1) / kBQ, batch * heads);
  int8_fwd_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
