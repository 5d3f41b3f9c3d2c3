// Banded (sliding temporal window) flash attention forward for Hopper (sm_90a),
// bf16 in, fp32 softmax: the video queries of windowed attention.
//
// Replaces the banded grid of the TPU kernel B4,
// s2v_tpu/ops/pallas/banded_attention.py::banded_flash_attention (its
// pallas_call of _flash_kernel over a frame-padded layout), and kernel B6,
// ::banded_flash_attention_local (_flash_kernel_sp: the same band for one
// sequence-parallel shard of video-query frames, at a runtime frame offset,
// against the full K/V).  The sequence is
// [global G (text | ref) | F frames of tpf tokens]; video query frame f
// attends the global keys [0, G) and the frames ws(f) .. ws(f) + span - 1,
//   ws(f) = clamp(f - w, 0, F - span),   span = min(2w + 1, F).
// The global queries attend everything; the wrapper sends them to kernel B1.
// B6's queries are a tensor of their own, [B, F_loc*tpf, H, d]: local frame fl
// is global frame frame_offset + fl, clamped with the global F, and frames at
// or past F (ring-padding dummy frames) take the last window.  One kernel
// serves both: the query frames start at row q_row0 of q/o (G for B4, 0 for
// B6) and at global frame frame_offset (0 for B4), both runtime arguments.
//
// It computes that contract, not the TPU layout: the window of frame f is one
// contiguous key range [G + ws(f)*tpf, G + (ws(f) + span)*tpf) of the original
// [B, S, H, d] order, so q/k/v are read through strides and each block walks
// two key ranges (no frame padding to 128 lanes, no -1e30 mask column, no
// pad-indicator row, no ones column).  A query tile never crosses a frame
// boundary, so a block has one window; the ragged ends of the query tile and
// of both key ranges are predicates.
//
// Bound on an H100 SXM at the main-path shape (B=2, H=48, G=1,576, tpf=1,350,
// F=13, w=2, d=64): 17,550 video queries x 8,326 keys each, 4*B*H*d*pairs =
// 3.59e12 operations, 3.63 ms at the 989 TFLOP/s bf16 tensor-core peak,
// against ~0.24 GB of q/k/v/o traffic (0.07 ms at 3.35 TB/s): compute-bound.
// B6 at world size 1 does the same work; a shard of a P-rank ring its real
// frames' share (~1/P), and it computes its dummy frames too.
//
// Design (B1's online kernel on a band; simple and right first):
//   * grid (F * ceil(tpf/128), B*H); 8 warps per block, 16 query rows per warp;
//   * K/V tiles of 64 keys double-buffered in shared memory with cp.async,
//     rows padded to 72 elements; tile j < ceil(G/64) is global, the rest walk
//     the window; keys past the end of their range read as zeros and get a
//     -inf logit;
//   * mma.sync m16n8k16 bf16 with fp32 accumulation; P re-packed in registers;
//   * online softmax (running max, rescale) in fp32; logits scaled in fp32
//     after the product, exponentials as exp2 with log2(e) in the scale.
// Output in bf16, plus the natural-log lse [B, H, S] at the video rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kD = 64;             // head dim (CogVideoX 2b and 5b)
constexpr int kBQ = 128;           // query rows per block
constexpr int kBK = 64;            // keys per tile
constexpr int kWarps = kBQ / 16;   // one m16 row slab per warp
constexpr int kThreads = kWarps * 32;
constexpr int kLds = kD + 8;       // padded shared-memory row, in elements
constexpr float kNegBig = -1e30f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000u); }

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  float* lse;  // [B, H, stat_rows] or null; written at the query rows only
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  int H, G, tpf, n_frames, span, window;
  int q_row0;        // row of q/o/lse holding the first query frame's first token
  int frame_offset;  // global frame of the first query frame
  int stat_rows;     // rows of a (b, h) slice of lse
  int q_tiles;       // query tiles per frame, ceil(tpf / kBQ)
  float scale_log2;  // softmax scale * log2(e)
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; valid == false zero-fills the destination.
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

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t load_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__global__ void __launch_bounds__(kThreads, 2) banded_fwd_kernel(const Params p) {
  __shared__ __align__(16) __nv_bfloat16 k_s[2][kBK * kLds];
  __shared__ __align__(16) __nv_bfloat16 v_s[2][kBK * kLds];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // fragment row group
  const int t4 = lane & 3;  // thread within the group
  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y % p.H;
  const int fl = blockIdx.x / p.q_tiles;  // this block's query frame in the call
  const int f = p.frame_offset + fl;      // ... and in the clip (>= F: a dummy frame)
  const int frame0 = p.q_row0 + fl * p.tpf;
  const int row_end = frame0 + p.tpf;  // rows of the frame: [frame0, row_end)
  const int row0 = frame0 + (blockIdx.x % p.q_tiles) * kBQ + warp * 16 + g;
  const int row1 = row0 + 8;

  // the frame's window: one contiguous key range after the global keys
  const int ws = min(max(f - p.window, 0), p.n_frames - p.span);
  const int win_lo = p.G + ws * p.tpf;
  const int win_hi = win_lo + p.span * p.tpf;
  const int glob_tiles = (p.G + kBK - 1) / kBK;
  const int n_tiles = glob_tiles + (p.span * p.tpf + kBK - 1) / kBK;

  const __nv_bfloat16* qp = p.q + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kp = p.k + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* vp = p.v + b * p.v_sb + h * p.v_sh;

  // A fragments of the warp's 16 query rows, all 64 dims (4 k16 chunks).
  uint32_t qf[4][4];
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
    const int c = kc * 16 + t4 * 2;
    qf[kc][0] = row0 < row_end ? load_u32(qp + row0 * p.q_ss + c) : 0u;
    qf[kc][1] = row1 < row_end ? load_u32(qp + row1 * p.q_ss + c) : 0u;
    qf[kc][2] = row0 < row_end ? load_u32(qp + row0 * p.q_ss + c + 8) : 0u;
    qf[kc][3] = row1 < row_end ? load_u32(qp + row1 * p.q_ss + c + 8) : 0u;
  }

  // tile j -> its first key and the end of its key range
  auto tile_range = [&](int j, int& kbase, int& kend) {
    if (j < glob_tiles) {
      kbase = j * kBK;
      kend = p.G;
    } else {
      kbase = win_lo + (j - glob_tiles) * kBK;
      kend = win_hi;
    }
  };

  auto load_tile = [&](int j, int buf) {
    int kbase, kend;
    tile_range(j, kbase, kend);
#pragma unroll
    for (int i = tid; i < kBK * (kD / 8); i += kThreads) {
      const int r = i >> 3;
      const int ch = (i & 7) * 8;
      const int key = kbase + r;
      const bool ok = key < kend;
      const long long kk = ok ? key : 0;
      cp_async16(&k_s[buf][r * kLds + ch], kp + kk * p.k_ss + ch, ok);
      cp_async16(&v_s[buf][r * kLds + ch], vp + kk * p.v_ss + ch, ok);
    }
  };

  float o_acc[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    o_acc[nt][0] = o_acc[nt][1] = o_acc[nt][2] = o_acc[nt][3] = 0.f;
  }
  float m_run[2] = {kNegBig, kNegBig};  // running max, log2 units
  float l_run[2] = {0.f, 0.f};          // this thread's share of the row sums

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

    // S = Q K^T: 16 rows x 64 keys per warp, 8 n8 tiles.
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {
        const __nv_bfloat16* kr = &k_s[buf][(nt * 8 + g) * kLds + kc * 16 + t4 * 2];
        const uint32_t bf[2] = {load_u32(kr), load_u32(kr + 8)};
        mma_bf16_16816(s[nt], qf[kc], bf);
      }
    }

    // scale to log2 units; keys past the end of the tile's range get -inf
    int kbase, kend;
    tile_range(j, kbase, kend);
    const bool need_mask = kbase + kBK > kend;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nt][e] * p.scale_log2;
        if (need_mask && kbase + nt * 8 + t4 * 2 + (e & 1) >= kend) x = neg_inf();
        s[nt][e] = x;
      }
    }

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
          reinterpret_cast<const uint16_t*>(&v_s[buf][(kc * 16 + t4 * 2) * kLds + g]);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const uint16_t* vc = vr + nt * 8;
        const uint32_t bf[2] = {
            uint32_t(vc[0]) | (uint32_t(vc[kLds]) << 16),
            uint32_t(vc[8 * kLds]) | (uint32_t(vc[9 * kLds]) << 16),
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
    if (row >= row_end) continue;
    const float l = l_run[r];  // > 0: every row sees at least one global key
    const float inv = 1.f / l;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const uint32_t packed = pack_bf16x2(o_acc[nt][2 * r] * inv, o_acc[nt][2 * r + 1] * inv);
      *reinterpret_cast<uint32_t*>(op + row * p.o_ss + nt * 8 + t4 * 2) = packed;
    }
    if (p.lse != nullptr && t4 == 0) {
      p.lse[((long long)b * p.H + h) * p.stat_rows + row] = m_run[r] * kLn2 + logf(l);
    }
  }
}

// shared by the two entry points: q frames [0, q_frames) at rows q_row0 + fl*tpf
int launch(const void* q, const void* k, const void* v, void* o, void* lse, int batch, int heads,
           int global_len, int tokens_per_frame, int n_frames, int span, int window, int q_row0,
           int frame_offset, int q_frames, int stat_rows, const long long* st, float scale_log2,
           void* stream) {
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.lse = static_cast<float*>(lse);
  p.q_sb = st[0]; p.q_ss = st[1]; p.q_sh = st[2];
  p.k_sb = st[3]; p.k_ss = st[4]; p.k_sh = st[5];
  p.v_sb = st[6]; p.v_ss = st[7]; p.v_sh = st[8];
  p.o_sb = st[9]; p.o_ss = st[10]; p.o_sh = st[11];
  p.H = heads;
  p.G = global_len;
  p.tpf = tokens_per_frame;
  p.n_frames = n_frames;
  p.span = span;
  p.window = window;
  p.q_row0 = q_row0;
  p.frame_offset = frame_offset;
  p.stat_rows = stat_rows;
  p.q_tiles = (tokens_per_frame + kBQ - 1) / kBQ;
  p.scale_log2 = scale_log2;
  const dim3 grid(q_frames * p.q_tiles, batch * heads);
  banded_fwd_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// B4: q, k, v, o all [B, S, H, d]; the video rows of o and lse ([B, H, S])
extern "C" int s2v_banded_attention_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse,
    int batch, int heads, int seq, int global_len, int tokens_per_frame, int n_frames,
    int span, int window,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    float scale_log2, void* stream) {
  const long long st[12] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh};
  return launch(q, k, v, o, lse, batch, heads, global_len, tokens_per_frame, n_frames, span, window,
                global_len, 0, n_frames, seq, st, scale_log2, stream);
}

// B6: q and o [B, F_loc*tpf, H, d] (frames frame_offset .. frame_offset + F_loc - 1),
// k and v the full [B, S, H, d]; lse [B, H, F_loc*tpf]
extern "C" int s2v_banded_attention_local_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse,
    int batch, int heads, int global_len, int tokens_per_frame, int n_frames,
    int span, int window, int frame_offset, int local_frames,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    float scale_log2, void* stream) {
  const long long st[12] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh};
  return launch(q, k, v, o, lse, batch, heads, global_len, tokens_per_frame, n_frames, span, window,
                0, frame_offset, local_frames, local_frames * tokens_per_frame, st, scale_log2, stream);
}
