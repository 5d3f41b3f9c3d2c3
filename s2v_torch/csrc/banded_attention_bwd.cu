// Banded (sliding temporal window) flash attention backward for Hopper
// (sm_90a), bf16 in, fp32 math: the gradients that the video queries of
// windowed attention send back.
//
// Replaces the banded kernels of the TPU kernel B5,
// s2v_tpu/ops/pallas/banded_attention_bwd.py::banded_flash_attention_bwd: the
// banded dq (_dq_kernel on the band), the inverse band (_dkv_banded_kernel,
// video keys <- video queries) and the global keys' sweep (_dkv_kernel,
// global keys <- video queries).  The global queries' part goes to kernel B2
// in the wrapper, which adds the two parts of dk and dv.
//
// And those of kernel B7, ::banded_flash_attention_local_bwd (_dq_kernel_sp,
// _dkv_banded_kernel_sp and the global-key sweep over the local frames): the
// same gradients for one sequence-parallel shard of video-query frames, q, o,
// dO, lse and D of its own length [B, F_loc*tpf, ...] at global frames
// frame_offset + fl, against the full K/V.  dq has the local length; dk and dv
// are the full-extent partials [B, S, H, d] from the local queries only (the
// wrapper sums them over the ranks).  Frames at or past F (ring-padding dummy
// frames) are absent: their dq rows are written as zero and the dk/dv walks
// stop at the last real frame, so they contribute exactly nothing.  One pair of
// kernels serves B5 and B7: the query frames start at row q_row0 of q/dO/dq (G
// for B5, 0 for B7) and at global frame frame_offset (0 for B5).
//
// The band (as in banded_attention.cu): the sequence is [global G | F frames
// of tpf tokens]; video query frame f attends [0, G) and the frames ws(f) ..
// ws(f) + span - 1, ws(f) = clamp(f - w, 0, F - span), span = min(2w + 1, F).
// Its inverse: key frame fk is attended by the query frames f_lo(fk) ..
// f_hi(fk), a contiguous interval,
//   f_lo(fk) = 0 if fk < span else fk + w - span + 1,
//   f_hi(fk) = F - 1 if fk >= F - span else min(F - 1, fk + w)
// (in a small clip, where span - 1 >= F - span, edge key frames take every
// query frame).  Global keys are attended by every video query.
//
// Given q, k, v, dO, the forward's natural-log lse and D = rowsum(dO * o), both
// [B, H, S] fp32, it recomputes P = exp(scale * q k^T - lse) per tile and
//   dV = P^T dO,   dS = P * (dO v^T - D),   dQ = scale * dS k,   dK = scale * dS^T q
// over the band only.  q/k/v/dO are read in their [B, S, H, d] layout through
// strides; every range (a frame's query rows, the two key ranges of a query
// frame, the query rows of a key tile) is contiguous, and its ragged end is a
// predicate (P = 0), not the TPU's frame padding, -1e30 column and +inf lse.
//
// Bound on an H100 SXM at the training shape (B=1, H=48, G=1,576, tpf=1,350,
// F=13, w=2, d=64): 17,550 video queries x 8,326 keys each, 10*B*H*d*pairs =
// 4.49e12 operations for the five products, 4.54 ms at the 989 TFLOP/s bf16
// peak, against ~0.2 GB of traffic: compute-bound.  B7 at world size 1 does
// the same work; a shard of a P-rank ring its real frames' share (~1/P).
//
// Design (B2's two deterministic kernels on the band; simple and right first):
//   dq kernel  - one block per (b*h, 64-query tile inside one frame); walks
//                the global key tiles, then the frame's window;
//   dkv kernel - one block per (b*h, 64-key tile); a key tile never crosses
//                the global/video boundary or a frame boundary; a global tile
//                walks every video query row [G, S), a tile of frame fk the
//                rows [G + f_lo(fk)*tpf, G + (f_hi(fk) + 1)*tpf);
//   no atomics, every output written by one block; 4 warps of 16 rows; the
//   streamed tiles double-buffered with cp.async in padded shared memory;
//   mma.sync m16n8k16 bf16, fp32 accumulation, P and dS re-packed to bf16 in
//   registers; q k^T and dO v^T computed in both kernels (7 products for the
//   bound's 5).  dq, and the dk, dv of the video queries' part, are written
//   into full-length [B, S, H, d] outputs: dq at the video rows, dk/dv at all.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kD = 64;            // head dim (CogVideoX 2b and 5b)
constexpr int kBR = 64;           // rows (queries or keys) a block owns
constexpr int kBT = 64;           // rows of each streamed tile
constexpr int kWarps = kBR / 16;  // one m16 row slab per warp
constexpr int kThreads = kWarps * 32;
constexpr int kLds = kD + 8;      // padded shared-memory row, in elements
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* dout;
  const float* lse;    // [B, H, stat_rows], natural log
  const float* delta;  // [B, H, stat_rows], rowsum(dO * o)
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long do_sb, do_ss, do_sh;
  long long dq_sb, dq_ss, dq_sh;
  long long dk_sb, dk_ss, dk_sh;
  long long dv_sb, dv_ss, dv_sh;
  int H, G, tpf, n_frames, span, window;
  int q_row0;        // row of q/dO/dq holding the first query frame's first token
  int frame_offset;  // global frame of the first query frame
  int q_frames;      // query frames of the call (the clip, or a shard with its dummy frames)
  int stat_rows;     // rows of a (b, h) slice of lse and D
  int frame_tiles;   // 64-row tiles per frame, ceil(tpf / 64)
  float scale;
  float scale_log2;  // scale * log2(e)
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

// 4-byte async copy (lse / D rows: no 16-byte alignment at an arbitrary row).
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  const int src_bytes = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
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

// A fragments of 16 rows x 64 dims straight from device memory (rows at or
// past row_end are zero): the operand a warp keeps in registers.
__device__ __forceinline__ void load_a_rows(uint32_t (&f)[4][4], const __nv_bfloat16* base,
                                            long long row_stride, int r0, int row_end, int t4) {
  const int r1 = r0 + 8;
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
    const int c = kc * 16 + t4 * 2;
    f[kc][0] = r0 < row_end ? load_u32(base + r0 * row_stride + c) : 0u;
    f[kc][1] = r1 < row_end ? load_u32(base + r1 * row_stride + c) : 0u;
    f[kc][2] = r0 < row_end ? load_u32(base + r0 * row_stride + c + 8) : 0u;
    f[kc][3] = r1 < row_end ? load_u32(base + r1 * row_stride + c + 8) : 0u;
  }
}

// acc[16 x 64] = A[16 x 64 dims] . T^T, T a [64 rows x 64 dims] tile in
// shared memory: the B operand is T's rows, read two dims at a time.
__device__ __forceinline__ void mma_a_tt(float (&acc)[8][4], const uint32_t (&a)[4][4],
                                         const __nv_bfloat16* tile, int g, int t4) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      const __nv_bfloat16* r = tile + (nt * 8 + g) * kLds + kc * 16 + t4 * 2;
      const uint32_t bf[2] = {load_u32(r), load_u32(r + 8)};
      mma_bf16_16816(acc[nt], a[kc], bf);
    }
  }
}

// out[16 x 64 dims] += X[16 x 64 tile rows] . T, X the fp32 accumulator of a
// previous product (re-packed to bf16 A fragments), T a [64 rows x 64 dims]
// tile in shared memory gathered as B fragments two 16-bit values at a time.
__device__ __forceinline__ void mma_acc_t(float (&out)[8][4], const float (&x)[8][4],
                                          const __nv_bfloat16* tile, int g, int t4) {
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
    const uint32_t pa[4] = {
        pack_bf16x2(x[2 * kc][0], x[2 * kc][1]),
        pack_bf16x2(x[2 * kc][2], x[2 * kc][3]),
        pack_bf16x2(x[2 * kc + 1][0], x[2 * kc + 1][1]),
        pack_bf16x2(x[2 * kc + 1][2], x[2 * kc + 1][3]),
    };
    const uint16_t* tr = reinterpret_cast<const uint16_t*>(tile + (kc * 16 + t4 * 2) * kLds + g);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const uint16_t* tc = tr + nt * 8;
      const uint32_t bf[2] = {
          uint32_t(tc[0]) | (uint32_t(tc[kLds]) << 16),
          uint32_t(tc[8 * kLds]) | (uint32_t(tc[9 * kLds]) << 16),
      };
      mma_bf16_16816(out[nt], pa, bf);
    }
  }
}

// write 16 rows x 64 dims of an fp32 accumulator, times `mul`, as bf16
__device__ __forceinline__ void store_rows(__nv_bfloat16* base, long long row_stride, int r0, int row_end,
                                           const float (&acc)[8][4], float mul, int t4) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    if (row >= row_end) continue;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const uint32_t packed = pack_bf16x2(acc[nt][2 * r] * mul, acc[nt][2 * r + 1] * mul);
      *reinterpret_cast<uint32_t*>(base + row * row_stride + nt * 8 + t4 * 2) = packed;
    }
  }
}

__device__ __forceinline__ void zero_acc(float (&acc)[8][4]) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
}

// dq of the video queries: one block per (64 queries of one frame, b*h);
// walks the global key tiles, then the frame's window.
__global__ void __launch_bounds__(kThreads) banded_bwd_dq_kernel(const Params p) {
  __shared__ __align__(16) __nv_bfloat16 k_s[2][kBT * kLds];
  __shared__ __align__(16) __nv_bfloat16 v_s[2][kBT * kLds];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y % p.H;
  const int fl = blockIdx.x / p.frame_tiles;  // query frame in the call
  const int f = p.frame_offset + fl;          // ... and in the clip
  const int frame0 = p.q_row0 + fl * p.tpf;
  const int row_end = frame0 + p.tpf;
  const int row0 = frame0 + (blockIdx.x % p.frame_tiles) * kBR + warp * 16 + g;  // rows row0, row0 + 8
  __nv_bfloat16* dqp = p.dq + b * p.dq_sb + h * p.dq_sh;
  float dq_acc[8][4];
  zero_acc(dq_acc);
  if (f >= p.n_frames) {  // a dummy frame (block-uniform): no gradient
    store_rows(dqp, p.dq_ss, row0, row_end, dq_acc, 0.f, t4);
    return;
  }

  const int ws = min(max(f - p.window, 0), p.n_frames - p.span);
  const int win_lo = p.G + ws * p.tpf;
  const int win_hi = win_lo + p.span * p.tpf;
  const int glob_tiles = (p.G + kBT - 1) / kBT;
  const int n_tiles = glob_tiles + (p.span * p.tpf + kBT - 1) / kBT;

  const __nv_bfloat16* qp = p.q + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* dop = p.dout + b * p.do_sb + h * p.do_sh;
  const __nv_bfloat16* kp = p.k + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* vp = p.v + b * p.v_sb + h * p.v_sh;

  uint32_t qf[4][4], dof[4][4];
  load_a_rows(qf, qp, p.q_ss, row0, row_end, t4);
  load_a_rows(dof, dop, p.do_ss, row0, row_end, t4);
  // lse in log2 units and D for the thread's two rows (0 outside the frame:
  // such rows have zero q and dO, so their dS is 0, and they are not written)
  float lse2[2], dlt[2];
  const long long stat = ((long long)b * p.H + h) * p.stat_rows;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    lse2[r] = row < row_end ? p.lse[stat + row] * kLog2e : 0.f;
    dlt[r] = row < row_end ? p.delta[stat + row] : 0.f;
  }

  auto tile_range = [&](int j, int& kbase, int& kend) {
    if (j < glob_tiles) {
      kbase = j * kBT;
      kend = p.G;
    } else {
      kbase = win_lo + (j - glob_tiles) * kBT;
      kend = win_hi;
    }
  };

  auto load_tile = [&](int j, int buf) {
    int kbase, kend;
    tile_range(j, kbase, kend);
#pragma unroll
    for (int i = tid; i < kBT * (kD / 8); i += kThreads) {
      const int r = i >> 3;
      const int ch = (i & 7) * 8;
      const int key = kbase + r;
      const bool ok = key < kend;
      const long long kk = ok ? key : 0;
      cp_async16(&k_s[buf][r * kLds + ch], kp + kk * p.k_ss + ch, ok);
      cp_async16(&v_s[buf][r * kLds + ch], vp + kk * p.v_ss + ch, ok);
    }
  };

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

    float s[8][4], dp[8][4];
    mma_a_tt(s, qf, k_s[buf], g, t4);    // S  = q k^T
    mma_a_tt(dp, dof, v_s[buf], g, t4);  // dP = dO v^T

    int kbase, kend;
    tile_range(j, kbase, kend);
    const bool tail = kbase + kBT > kend;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float pr = fast_exp2(s[nt][e] * p.scale_log2 - lse2[r]);
        if (tail && kbase + nt * 8 + t4 * 2 + (e & 1) >= kend) pr = 0.f;
        s[nt][e] = pr * (dp[nt][e] - dlt[r]);  // dS, in place of S
      }
    }
    mma_acc_t(dq_acc, s, k_s[buf], g, t4);  // dq += dS k
    __syncthreads();  // the next iteration's copy overwrites this buffer
  }

  store_rows(dqp, p.dq_ss, row0, row_end, dq_acc, p.scale, t4);
}

// dk, dv from the video queries: one block per (64 keys, b*h).  Blocks
// [0, ceil(G/64)) own global key tiles and walk every real query frame of the
// call; the rest own tiles of one key frame and walk the call's query frames
// in that frame's inverse band (an empty walk writes zeros).
__global__ void __launch_bounds__(kThreads) banded_bwd_dkv_kernel(const Params p) {
  __shared__ __align__(16) __nv_bfloat16 q_s[2][kBT * kLds];
  __shared__ __align__(16) __nv_bfloat16 do_s[2][kBT * kLds];
  __shared__ __align__(16) float lse_s[2][kBT];
  __shared__ __align__(16) float dlt_s[2][kBT];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y % p.H;

  const int glob_tiles = (p.G + kBR - 1) / kBR;
  const int off = p.frame_offset;
  int tile0, key_end, q_lo, q_hi;  // query rows [q_lo, q_hi) of q/dO/lse/D
  if ((int)blockIdx.x < glob_tiles) {
    tile0 = blockIdx.x * kBR;
    key_end = p.G;
    const int real = max(0, min(p.q_frames, p.n_frames - off));
    q_lo = p.q_row0;
    q_hi = p.q_row0 + real * p.tpf;
  } else {
    const int i = blockIdx.x - glob_tiles;
    const int fk = i / p.frame_tiles;
    tile0 = p.G + fk * p.tpf + (i % p.frame_tiles) * kBR;
    key_end = p.G + (fk + 1) * p.tpf;
    const int f_lo = fk < p.span ? 0 : fk + p.window - p.span + 1;
    const int f_hi = fk >= p.n_frames - p.span ? p.n_frames - 1 : min(p.n_frames - 1, fk + p.window);
    // the inverse band's frames that the call holds (f_hi < F: real frames only)
    const int lo = max(f_lo, off);
    const int hi = min(f_hi, off + p.q_frames - 1);
    q_lo = p.q_row0 + (lo - off) * p.tpf;
    q_hi = hi >= lo ? p.q_row0 + (hi - off + 1) * p.tpf : q_lo;
  }
  const int key0 = tile0 + warp * 16 + g;  // this thread's keys: key0, key0 + 8

  const __nv_bfloat16* kp = p.k + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* vp = p.v + b * p.v_sb + h * p.v_sh;
  const __nv_bfloat16* qp = p.q + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* dop = p.dout + b * p.do_sb + h * p.do_sh;
  const long long stat = ((long long)b * p.H + h) * p.stat_rows;

  uint32_t kf[4][4], vf[4][4];
  load_a_rows(kf, kp, p.k_ss, key0, key_end, t4);
  load_a_rows(vf, vp, p.v_ss, key0, key_end, t4);

  auto load_tile = [&](int j, int buf) {
    const int base = q_lo + j * kBT;
#pragma unroll
    for (int i = tid; i < kBT * (kD / 8); i += kThreads) {
      const int r = i >> 3;
      const int ch = (i & 7) * 8;
      const int qrow = base + r;
      const bool ok = qrow < q_hi;
      const long long qq = ok ? qrow : 0;
      cp_async16(&q_s[buf][r * kLds + ch], qp + qq * p.q_ss + ch, ok);
      cp_async16(&do_s[buf][r * kLds + ch], dop + qq * p.do_ss + ch, ok);
    }
    if (tid < kBT) {
      const int qrow = base + tid;
      const bool ok = qrow < q_hi;
      const long long qq = ok ? qrow : 0;
      cp_async4(&lse_s[buf][tid], p.lse + stat + qq, ok);
      cp_async4(&dlt_s[buf][tid], p.delta + stat + qq, ok);
    }
  };

  float dk_acc[8][4], dv_acc[8][4];
  zero_acc(dk_acc);
  zero_acc(dv_acc);

  const int n_tiles = (q_hi - q_lo + kBT - 1) / kBT;
  if (n_tiles > 0) {
    load_tile(0, 0);
    cp_async_commit();
  }
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

    // P^T = exp(scale * k q^T - lse[query]): rows are keys, columns queries;
    // query rows past the end of the range get P = 0
    float pt[8][4];
    mma_a_tt(pt, kf, q_s[buf], g, t4);
    const int qbase = q_lo + j * kBT;
    const bool tail = qbase + kBT > q_hi;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + t4 * 2 + (e & 1);
        float pr = fast_exp2(pt[nt][e] * p.scale_log2 - lse_s[buf][col] * kLog2e);
        if (tail && qbase + col >= q_hi) pr = 0.f;
        pt[nt][e] = pr;
      }
    }
    mma_acc_t(dv_acc, pt, do_s[buf], g, t4);  // dv += P^T dO

    float dpt[8][4];
    mma_a_tt(dpt, vf, do_s[buf], g, t4);  // dP^T = v dO^T
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + t4 * 2 + (e & 1);
        dpt[nt][e] = pt[nt][e] * (dpt[nt][e] - dlt_s[buf][col]);  // dS^T
      }
    }
    mma_acc_t(dk_acc, dpt, q_s[buf], g, t4);  // dk += dS^T q
    __syncthreads();
  }

  __nv_bfloat16* dkp = p.dk + b * p.dk_sb + h * p.dk_sh;
  __nv_bfloat16* dvp = p.dv + b * p.dv_sb + h * p.dv_sh;
  store_rows(dkp, p.dk_ss, key0, key_end, dk_acc, p.scale, t4);
  store_rows(dvp, p.dv_ss, key0, key_end, dv_acc, 1.f, t4);
}

// shared by the two entry points: query frames [0, q_frames) at rows q_row0 + fl*tpf
int launch(const void* q, const void* k, const void* v, const void* dout, const void* lse,
           const void* delta, void* dq, void* dk, void* dv, int batch, int heads, int global_len,
           int tokens_per_frame, int n_frames, int span, int window, int q_row0, int frame_offset,
           int q_frames, int stat_rows, const long long* st, float scale, void* stream) {
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.dout = static_cast<const __nv_bfloat16*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dq = static_cast<__nv_bfloat16*>(dq);
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  p.q_sb = st[0]; p.q_ss = st[1]; p.q_sh = st[2];
  p.k_sb = st[3]; p.k_ss = st[4]; p.k_sh = st[5];
  p.v_sb = st[6]; p.v_ss = st[7]; p.v_sh = st[8];
  p.do_sb = st[9]; p.do_ss = st[10]; p.do_sh = st[11];
  p.dq_sb = st[12]; p.dq_ss = st[13]; p.dq_sh = st[14];
  p.dk_sb = st[15]; p.dk_ss = st[16]; p.dk_sh = st[17];
  p.dv_sb = st[18]; p.dv_ss = st[19]; p.dv_sh = st[20];
  p.H = heads;
  p.G = global_len;
  p.tpf = tokens_per_frame;
  p.n_frames = n_frames;
  p.span = span;
  p.window = window;
  p.q_row0 = q_row0;
  p.frame_offset = frame_offset;
  p.q_frames = q_frames;
  p.stat_rows = stat_rows;
  p.frame_tiles = (tokens_per_frame + kBR - 1) / kBR;
  p.scale = scale;
  p.scale_log2 = scale * kLog2e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int glob_tiles = (global_len + kBR - 1) / kBR;
  banded_bwd_dq_kernel<<<dim3(q_frames * p.frame_tiles, batch * heads), kThreads, 0, s>>>(p);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  banded_bwd_dkv_kernel<<<dim3(glob_tiles + n_frames * p.frame_tiles, batch * heads), kThreads, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// B5: every tensor [B, S, H, d], lse and D [B, H, S]; dq at the video rows, dk/dv at all
extern "C" int s2v_banded_attention_bwd(
    const void* q, const void* k, const void* v, const void* dout, const void* lse,
    const void* delta, void* dq, void* dk, void* dv,
    int batch, int heads, int seq, int global_len, int tokens_per_frame, int n_frames,
    int span, int window,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long do_sb, long long do_ss, long long do_sh,
    long long dq_sb, long long dq_ss, long long dq_sh,
    long long dk_sb, long long dk_ss, long long dk_sh,
    long long dv_sb, long long dv_ss, long long dv_sh,
    float scale, void* stream) {
  const long long st[21] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, do_sb, do_ss,
                            do_sh, dq_sb, dq_ss, dq_sh, dk_sb, dk_ss, dk_sh, dv_sb, dv_ss, dv_sh};
  return launch(q, k, v, dout, lse, delta, dq, dk, dv, batch, heads, global_len, tokens_per_frame,
                n_frames, span, window, global_len, 0, n_frames, seq, st, scale, stream);
}

// B7: q, dO, dq [B, F_loc*tpf, H, d] and lse, D [B, H, F_loc*tpf] of the shard at
// frame_offset; k, v and the partial dk, dv the full [B, S, H, d]
extern "C" int s2v_banded_attention_local_bwd(
    const void* q, const void* k, const void* v, const void* dout, const void* lse,
    const void* delta, void* dq, void* dk, void* dv,
    int batch, int heads, int global_len, int tokens_per_frame, int n_frames,
    int span, int window, int frame_offset, int local_frames,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long do_sb, long long do_ss, long long do_sh,
    long long dq_sb, long long dq_ss, long long dq_sh,
    long long dk_sb, long long dk_ss, long long dk_sh,
    long long dv_sb, long long dv_ss, long long dv_sh,
    float scale, void* stream) {
  const long long st[21] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, do_sb, do_ss,
                            do_sh, dq_sb, dq_ss, dq_sh, dk_sb, dk_ss, dk_sh, dv_sb, dv_ss, dv_sh};
  return launch(q, k, v, dout, lse, delta, dq, dk, dv, batch, heads, global_len, tokens_per_frame,
                n_frames, span, window, 0, frame_offset, local_frames, local_frames * tokens_per_frame,
                st, scale, stream);
}
