// Banded (sliding temporal window) flash attention forward for Hopper (sm_90a),
// bf16 in, fp32 softmax: the video queries of windowed attention.
//
// Replaces the banded grid of the TPU kernel B4,
// s2v_tpu/ops/pallas/banded_attention.py::banded_flash_attention (its
// pallas_call of _flash_kernel over a frame-padded layout), and kernel B6,
// ::banded_flash_attention_local (_flash_kernel_sp: the same band for one
// sequence-parallel shard of video-query frames, at a runtime frame offset,
// against the full K/V).  The band is band.cuh's: video query frame f attends
// the global keys [0, G) and the frames ws(f) .. ws(f) + span - 1.  The global
// queries attend everything; the wrapper sends them to kernel B1.  B6's
// queries are a tensor of their own, [B, F_loc*tpf, H, d]: local frame fl is
// global frame frame_offset + fl, and frames at or past F (ring-padding dummy
// frames) take the last window.  One __global__ serves both: the query frames
// start at row q_row0 of q/o (G for B4, 0 for B6) and at global frame
// frame_offset (0 for B4), both runtime arguments, so B6 at one rank computes
// B4's video rows bit for bit.
//
// It computes that contract, not the TPU layout: a frame's window is one
// contiguous key range of the original [B, S, H, d] order, so q/k/v are read
// through strides (TMA maps) and each block walks two key ranges (no frame
// padding to 128 lanes, no -1e30 mask column, no pad-indicator row).
//
// Bound on an H100 SXM at the main-path shape (B=2, H=48, G=1,576, tpf=1,350,
// F=13, w=2, d=64): 17,550 video queries x 8,326 keys each, 4*B*H*d*pairs =
// 3.59e12 operations, 3.63 ms at the 989 TFLOP/s bf16 tensor-core peak,
// against ~0.24 GB of q/k/v/o traffic (0.07 ms at 3.35 TB/s): compute-bound,
// with the exponentials (1.4e10) a second ceiling of ~3.8 ms on the SFUs.
// B6 at world size 1 does the same work; a shard of a P-rank ring its real
// frames' share (~1/P), and it computes its dummy frames too.
//
// Design: kernel B1's (flash_attention.cu, on hopper.cuh) on a band.
//   * grid (F_loc * ceil(tpf/128), B*H): a block owns 128 query rows of one
//     frame; 3 warpgroups: warpgroup 0 is the producer (one thread issues
//     TMA, setmaxnreg gives its registers away), warpgroups 1 and 2 each own
//     64 query rows;
//   * q: one TMA load of the block's 128 rows (16 KB, 128B-swizzled) through
//     a map over q's own tensor, kept in shared memory as the A operand of
//     S = q.K^T (wgmma m64n128k16, both operands from shared memory: the 16
//     registers of a q fragment stay free);
//   * K and V stream in 128-key tiles through a ring of kStages stages with
//     full/empty mbarriers, in the order of band::key_walk: the global range,
//     then the window (one range when ws = 0);
//   * the softmax runs online in fp32 registers with ex2.approx; P is
//     re-packed to bf16 registers as the A operand of O += P.V (wgmma
//     m64n64k16, V read MN-major with the transpose bit); the two consumer
//     warpgroups run independently, so one's exponentials overlap the
//     other's products.
// What differs from B1, and is handled here:
//   * two key ranges, and TMA masks neither: a tile that runs past the end of
//     its range brings the next range's real keys (at the main shape the last
//     global tile holds 88 video keys, the last window tile 34 keys of the
//     next frame).  Every tile whose range ends inside it gets -inf logits
//     past kend: at most two tiles a block;
//   * the query tile ends at the frame, not at the tensor (tpf = 10*128 + 70):
//     the last tile's TMA box reads the next frame's rows (or zeros past the
//     tensor), whose results are never stored; o and lse writes are
//     predicated on the frame's end;
//   * B6's dummy frames take the last window, as the TPU kernel does.
// Output in bf16, plus the natural-log lse [B, H, stat_rows] at the query rows.

#include "band.cuh"
#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kD = 64;            // head dim (CogVideoX 2b and 5b)
constexpr int kRowsPerWg = 64;    // query rows of one consumer warpgroup
constexpr int kConsumers = 2;     // consumer warpgroups
constexpr int kBQ = kRowsPerWg * kConsumers;
constexpr int kBK = 128;          // keys per tile
constexpr int kStages = 3;
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr uint32_t kTileBytes = kBK * kD * 2;
constexpr float kNegBig = -1e30f;
constexpr float kLn2 = 0.6931471805599453f;

struct Smem {
  __nv_bfloat16 q[kBQ * kD];           // 16 KB, so every tile below stays 1024-aligned
  __nv_bfloat16 k[kStages][kBK * kD];
  __nv_bfloat16 v[kStages][kBK * kD];
  uint64_t full[kStages];
  uint64_t empty[kStages];
  uint64_t q_full;
};
constexpr int kSmemBytes = sizeof(Smem) + 1024;

struct Params {
  CUtensorMap q_map;  // box (64, kBQ), over q's own tensor
  CUtensorMap k_map;  // box (64, kBK)
  CUtensorMap v_map;
  __nv_bfloat16* o;
  float* lse;  // [B, H, stat_rows] or null; written at the query rows only
  long long o_sb, o_ss, o_sh;
  int H, G, tpf, n_frames, span, window;
  int q_row0;        // row of q/o/lse holding the first query frame's first token
  int frame_offset;  // global frame of the first query frame
  int stat_rows;     // rows of a (b, h) slice of lse
  int q_tiles;       // query tiles per frame, ceil(tpf / kBQ)
  float scale_log2;  // softmax scale * log2(e)
};

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000u); }

// The block's query frame: its rows [frame0, frame0 + tpf) of q/o, the first
// row of its tile, and its key walk.
struct Block {
  int frame0;
  int tile_row;
  band::KeyWalk walk;
};

__device__ __forceinline__ Block block_of(const Params& p) {
  const int fl = blockIdx.x / p.q_tiles;  // query frame in the call
  const int f = p.frame_offset + fl;      // ... and in the clip (>= F: a dummy frame)
  Block blk;
  blk.frame0 = p.q_row0 + fl * p.tpf;
  blk.tile_row = blk.frame0 + (blockIdx.x % p.q_tiles) * kBQ;
  blk.walk = band::key_walk<kBK>(p.G, p.tpf, band::window_start(f, p.window, p.n_frames, p.span), p.span);
  return blk;
}

__device__ __forceinline__ void consumer(const Params& p, Smem& sm, const Block& blk, int wg, int b, int h) {
  const int tid = threadIdx.x & 127;
  const int lane = tid & 31;
  const int t = lane & 3;
  const int row0 = blk.tile_row + wg * kRowsPerWg + (tid >> 5) * 16 + (lane >> 2);  // and row0 + 8
  const int row_end = blk.frame0 + p.tpf;
  const __nv_bfloat16* q_s = sm.q + wg * kRowsPerWg * kD;  // this warpgroup's 64 rows

  float o_acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o_acc[i] = 0.f;
  float m_run[2] = {kNegBig, kNegBig};  // running max, log2 units
  float l_run[2] = {0.f, 0.f};          // this thread's share of the row sums
  const float c = p.scale_log2;
  mbar_wait(&sm.q_full, 0);

  float s[64];
  for (int j = 0; j < blk.walk.n_tiles; ++j) {
    const int st = j % kStages;
    mbar_wait(&sm.full[st], (j / kStages) & 1);

    // S = q K^T: 64 rows x 128 keys
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      mma_m64n128k16_ss<0>(s, desc_kmajor(q_s, kk), desc_kmajor(sm.k[st], kk), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    // keys past the end of the tile's range (the next range's, or zeros) get -inf
    int kbase, kend;
    band::tile_keys<kBK>(blk.walk, j, kbase, kend);
    if (kbase + kBK > kend) {
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        const int col = (i >> 2) * 8 + t * 2 + (i & 1);
        if (kbase + col >= kend) s[i] = neg_inf();
      }
    }

    float mx0 = neg_inf(), mx1 = neg_inf();
#pragma unroll
    for (int j8 = 0; j8 < 16; ++j8) {
      mx0 = fmaxf(mx0, fmaxf(s[4 * j8], s[4 * j8 + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * j8 + 2], s[4 * j8 + 3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    // the max in log2 units (scale > 0); every tile holds a key of its range
    const float new0 = fmaxf(m_run[0], mx0 * c);
    const float new1 = fmaxf(m_run[1], mx1 * c);
    const float a0 = fast_exp2(m_run[0] - new0);
    const float a1 = fast_exp2(m_run[1] - new1);
    m_run[0] = new0;
    m_run[1] = new1;
    l_run[0] *= a0;
    l_run[1] *= a1;
#pragma unroll
    for (int j8 = 0; j8 < 8; ++j8) {
      o_acc[4 * j8 + 0] *= a0;
      o_acc[4 * j8 + 1] *= a0;
      o_acc[4 * j8 + 2] *= a1;
      o_acc[4 * j8 + 3] *= a1;
    }
#pragma unroll
    for (int j8 = 0; j8 < 16; ++j8) {
      s[4 * j8 + 0] = fast_exp2(fmaf(s[4 * j8 + 0], c, -new0));
      s[4 * j8 + 1] = fast_exp2(fmaf(s[4 * j8 + 1], c, -new0));
      s[4 * j8 + 2] = fast_exp2(fmaf(s[4 * j8 + 2], c, -new1));
      s[4 * j8 + 3] = fast_exp2(fmaf(s[4 * j8 + 3], c, -new1));
      l_run[0] += s[4 * j8] + s[4 * j8 + 1];
      l_run[1] += s[4 * j8 + 2] + s[4 * j8 + 3];
    }

    // O += P V: P re-packed from the S accumulator as bf16 A fragments
    uint32_t pa[8][4];
#pragma unroll
    for (int kc = 0; kc < 8; ++kc) acc_to_a(pa[kc], s, kc);
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < 8; ++kc) mma_m64n64k16_rs<1>(o_acc, pa[kc], desc_mnmajor(sm.v[st], kc), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o_acc);
    fence_regs(pa);
    if (lane == 0) mbar_arrive(&sm.empty[st]);  // this warp is done with the stage
  }

  // full row sums: reduce over the four threads that share a row
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
  // l > 0: every row sees at least one global key
  store_rows(p.o + b * p.o_sb + h * p.o_sh, p.o_ss, row0, row_end, o_acc, 1.f / l_run[0], 1.f / l_run[1], t);
  if (p.lse != nullptr && t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row < row_end) p.lse[((long long)b * p.H + h) * p.stat_rows + row] = m_run[r] * kLn2 + logf(l_run[r]);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1) banded_fwd_kernel(const __grid_constant__ Params p) {
  extern __shared__ uint8_t smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(align_1024(smem_raw));
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);  // warp-uniform
  const int b = blockIdx.y / p.H;
  const int h = blockIdx.y % p.H;
  const Block blk = block_of(p);

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&sm.full[st], 1);
      mbar_init(&sm.empty[st], kConsumers * 4);  // one arrival per consumer warp
    }
    mbar_init(&sm.q_full, 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      prefetch_tensor_map(&p.q_map);
      prefetch_tensor_map(&p.k_map);
      prefetch_tensor_map(&p.v_map);
      mbar_arrive_expect_tx(&sm.q_full, kBQ * kD * 2);
      tma_load_rows(sm.q, &p.q_map, &sm.q_full, blk.tile_row, h, b);
      for (int j = 0; j < blk.walk.n_tiles; ++j) {
        const int st = j % kStages;
        int kbase, kend;
        band::tile_keys<kBK>(blk.walk, j, kbase, kend);
        mbar_wait(&sm.empty[st], ((j / kStages) & 1) ^ 1);  // the first round passes at once
        mbar_arrive_expect_tx(&sm.full[st], 2 * kTileBytes);
        tma_load_rows(sm.k[st], &p.k_map, &sm.full[st], kbase, h, b);
        tma_load_rows(sm.v[st], &p.v_map, &sm.full[st], kbase, h, b);
      }
    }
  } else {
    setmaxnreg_inc<232>();
    consumer(p, sm, blk, wg - 1, b, h);
  }
}

// shared by the two entry points: q frames [0, q_frames) at rows q_row0 + fl*tpf
// of a q tensor of q_len rows
int launch(const void* q, const void* k, const void* v, void* o, void* lse, int batch, int heads, int q_len,
           int seq, int global_len, int tokens_per_frame, int n_frames, int span, int window, int q_row0,
           int frame_offset, int q_frames, int stat_rows, const long long* st, float scale_log2, void* stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t err =
        cudaFuncSetAttribute(banded_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  Params p;
  int err = make_bshd_map(&p.q_map, q, batch, q_len, heads, st[0], st[1], st[2], kBQ);
  if (err != 0) return err;
  if ((err = make_bshd_map(&p.k_map, k, batch, seq, heads, st[3], st[4], st[5], kBK)) != 0) return err;
  if ((err = make_bshd_map(&p.v_map, v, batch, seq, heads, st[6], st[7], st[8], kBK)) != 0) return err;
  p.o = static_cast<__nv_bfloat16*>(o);
  p.lse = static_cast<float*>(lse);
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
  banded_fwd_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Dynamic shared memory a block of the kernel asks for, in bytes.
extern "C" int s2v_banded_attention_fwd_smem_bytes() { return kSmemBytes; }

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
  return launch(q, k, v, o, lse, batch, heads, seq, seq, global_len, tokens_per_frame, n_frames, span, window,
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
  const int q_len = local_frames * tokens_per_frame;
  return launch(q, k, v, o, lse, batch, heads, q_len, global_len + n_frames * tokens_per_frame, global_len,
                tokens_per_frame, n_frames, span, window, 0, frame_offset, local_frames, q_len, st, scale_log2,
                stream);
}
