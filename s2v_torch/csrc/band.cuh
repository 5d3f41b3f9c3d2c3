// The band of windowed attention, shared by kernels B4-B7
// (banded_attention.cu, banded_attention_bwd.cu).
//
// The sequence is [global G (text | ref) | F frames of tpf tokens].  Video
// query frame f attends the global keys [0, G) and the frames
// ws(f) .. ws(f) + span - 1,
//   ws(f) = clamp(f - w, 0, F - span),   span = min(2w + 1, F);
// a frame at or past F (a ring-padding dummy frame of B6/B7) takes the last
// window, as the clamp gives.  Its inverse: key frame fk is attended by the
// query frames f_lo(fk) .. f_hi(fk), a contiguous interval,
//   f_lo(fk) = 0 if fk < span else fk + w - span + 1,
//   f_hi(fk) = F - 1 if fk >= F - span else min(F - 1, fk + w)
// (in a small clip, where span - 1 >= F - span, edge key frames take every
// query frame).  Global keys are attended by every video query.
//
// A query frame's keys are two contiguous ranges of the [B, S, H, d] order,
// [0, G) and the window [G + ws*tpf, G + (ws + span)*tpf); when ws = 0 they
// touch and are walked as one.  A tile of TILE keys that runs past the end of
// its range holds keys of the next range (or zeros past S, from TMA): those
// keys are the caller's to exclude, on at most one tile per range.

#pragma once

namespace band {

__device__ __forceinline__ int window_start(int f, int window, int n_frames, int span) {
  return min(max(f - window, 0), n_frames - span);
}

// The key tiles of one query frame, in the order the producer issues them.
struct KeyWalk {
  int end0;     // end of the first range: G, or the window's end when the two touch
  int n_first;  // tiles of the first range, [0, end0)
  int win_lo;   // the window range [win_lo, win_hi), walked after the first
  int win_hi;
  int n_tiles;
};

template <int TILE>
__device__ __forceinline__ KeyWalk key_walk(int G, int tpf, int ws, int span) {
  KeyWalk w;
  w.win_lo = G + ws * tpf;
  w.win_hi = w.win_lo + span * tpf;
  const bool joined = ws == 0;
  w.end0 = joined ? w.win_hi : G;
  w.n_first = (w.end0 + TILE - 1) / TILE;
  w.n_tiles = w.n_first + (joined ? 0 : (span * tpf + TILE - 1) / TILE);
  return w;
}

// tile j of the walk: its first key and the end of its range (keys at or
// past kend are not the frame's)
template <int TILE>
__device__ __forceinline__ void tile_keys(const KeyWalk& w, int j, int& kbase, int& kend) {
  if (j < w.n_first) {
    kbase = j * TILE;
    kend = w.end0;
  } else {
    kbase = w.win_lo + (j - w.n_first) * TILE;
    kend = w.win_hi;
  }
}

// the query frames whose window holds key frame fk
__device__ __forceinline__ void inverse_band(int fk, int window, int n_frames, int span, int& f_lo, int& f_hi) {
  f_lo = fk < span ? 0 : fk + window - span + 1;
  f_hi = fk >= n_frames - span ? n_frames - 1 : min(n_frames - 1, fk + window);
}

}  // namespace band
