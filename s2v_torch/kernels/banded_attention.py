"""Kernel B4: banded (sliding temporal window) flash attention, a CUDA C++
kernel for Hopper.

Replaces ``s2v_tpu/ops/pallas/banded_attention.py::banded_flash_attention``.
The sequence is ``[global G (text | ref) | F frames of tpf tokens]``.  Video
query frame f attends the global keys and the frames ``ws(f) .. ws(f) + span
- 1`` with ``ws(f) = clamp(f - w, 0, F - span)`` and ``span = min(2w + 1, F)``
(the window is clamped at the clip's edges, so every frame sees ``span``
frames); the global queries attend the whole sequence.  Same semantics as
``windowed_attention_reference`` (``s2v_torch/ops/windowed_attention.py``).

On CUDA the global queries go through one B1 call in the online softmax mode
(``s2v_torch.kernels.flash_attention``; the TPU function does the same) and
the video queries through one launch of ``s2v_torch/csrc/banded_attention.cu``
(on ``csrc/hopper.cuh`` and ``csrc/band.cuh``), compiled with ``nvcc`` for
``sm_90a`` into ``build/`` on the first CUDA call and bound with ``ctypes``.
It is B1's design on the band: per block of 128 query rows of one frame, a
producer warpgroup loads q once and streams 128-key K/V tiles with TMA
through an mbarrier ring, over the global range and then the frame's
window, and two consumer warpgroups run ``wgmma`` (q·kᵀ from shared memory,
P·V with P in registers) and the online softmax; the keys of a tile that lie
past its range's end, and the query rows past the frame's end, are
predicated.  :func:`banded_flash_attention_blocked` emulates that schedule
in PyTorch on any device.  CPU tensors take
:func:`banded_flash_attention_reference`, the plain PyTorch version.
``native.count`` records each launch of the banded kernel as
``banded_flash_attention``.

Kernel B6, :func:`banded_flash_attention_local`, replaces
``s2v_tpu/ops/pallas/banded_attention.py::banded_flash_attention_local``:
the same band for one sequence-parallel shard of video-query frames,
``[B, F_loc·tpf, H, d]``, against the full K/V ``[B, G + F·tpf, H, d]``.
The shard's first frame ``frame_offset`` is a runtime kernel argument (one
build serves every rank); windows clamp to the global frame range, and
frames at or past F (ring-padding dummy frames) attend the last window,
giving rows the caller drops.  It shares the ``__global__`` kernel with B4
through its own C entry point ``s2v_banded_attention_local_fwd``;
:func:`banded_flash_attention_local_reference` is its plain version and
``banded_flash_attention_local`` its own count.

Element types: bf16 (the 5b models) and fp16 (the 2b family), one kernel
templated on the type, two C entry points for each of B4 and B6 (``ENTRY``,
``LOCAL_ENTRY``).  From fp16 inputs the kernel computes what the JAX package
computes after its fp32 upcast, except that P is rounded to fp16 for P·V;
the softmax is online, so P ≤ 1 against each row's running max and fp16
needs no offset.  fp32 inputs launch the fp32 kernel of
``csrc/attention_f32.cu`` on the same band (``kernels/attention_f32.py``,
3xTF32).  Each count is also kept by element type.

Bound on an H100 SXM at the main-path shape (B=2, H=48, G=1,576, tpf=1,350,
F=13, w=2, d=64): the banded launch does 4·B·H·d·(17,550 × 8,326) = 3.59·10¹²
operations (3.63 ms at 989 TFLOP/s bf16), the global queries' B1 call
4·B·H·d·(1,576 × 19,126) = 7.4·10¹¹ (0.75 ms); both compute-bound.  B6 at
world size 1 does the banded launch's work; a shard of a P-rank ring does
its real frames' share (:meth:`BandGeometry.shard_pairs`).
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Optional, Tuple

import torch

from s2v_torch.kernels import attention_f32, native
from s2v_torch.kernels.flash_attention import (
    LN2,
    LOG2E,
    REFERENCE_CHUNK,
    check_kernel_inputs,
    flash_attention,
    flash_attention_reference,
)
from s2v_torch.kernels.native import F32, I32, I64, PTR, STREAM, ptr
from s2v_torch.utils import native_build

SOURCE = native_build.CSRC_DIR / "banded_attention.cu"
# the C entry points of each element type: B4's and B6's
ENTRY = {torch.bfloat16: "s2v_banded_attention_fwd", torch.float16: "s2v_banded_attention_fwd_f16"}
LOCAL_ENTRY = {torch.bfloat16: "s2v_banded_attention_local_fwd", torch.float16: "s2v_banded_attention_local_fwd_f16"}
# a block of the kernel owns KERNEL_QUERY_TILE query rows of one frame and
# streams K/V in tiles of KERNEL_KEY_TILE keys
KERNEL_QUERY_TILE = 128
KERNEL_KEY_TILE = 128
LIB = native_build.Library(SOURCE, {**{name: [PTR] * 5 + [I32] * ints + [I64] * 12 + [F32, STREAM]
                                 for entries, ints in ((ENTRY, 8), (LOCAL_ENTRY, 9)) for name in entries.values()},
                              "s2v_banded_attention_fwd_smem_bytes": []})


class BandGeometry(NamedTuple):
    """Static geometry of a windowed call, from host ints."""

    global_len: int  # G: the text | ref tokens, attended by and attending everything
    tokens_per_frame: int
    n_frames: int  # F
    window: int  # w: the half-width in frames
    span: int  # min(2w + 1, F): frames each video query attends
    # the video-query frames a call computes: global frames frame_offset ..
    # frame_offset + local_frames - 1 (the whole clip, or one SP shard)
    frame_offset: int = 0
    local_frames: int = 0

    def window_start(self, f: int) -> int:
        """ws(f): the first key frame of query frame f's window."""
        return min(max(f - self.window, 0), self.n_frames - self.span)

    def inverse_band(self, fk: int) -> Tuple[int, int]:
        """(f_lo, f_hi): the query frames whose window holds key frame fk, a
        contiguous interval (``s2v_tpu/ops/pallas/banded_attention_bwd.py:23-27``;
        in a small clip, span - 1 >= F - span, edge key frames take every
        query frame).  Kernel B5 computes the same formula on the device."""
        w, f, span = self.window, self.n_frames, self.span
        f_lo = 0 if fk < span else fk + w - span + 1
        f_hi = f - 1 if fk >= f - span else min(f - 1, fk + w)
        return f_lo, f_hi

    def key_tiles(self, f: int, tile: int) -> List[Tuple[int, int]]:
        """``(kbase, kend)`` of each key tile of query frame f, in the order
        the kernels' producers issue them (``csrc/band.cuh``): the global
        range, then the window, walked as one range when they touch (ws = 0).
        A tile holds keys ``[kbase, min(kbase + tile, kend))`` of its range;
        the kernel's tile runs on past kend, and those keys are predicated
        out.  Frames at or past F take the last window."""
        g, tpf = self.global_len, self.tokens_per_frame
        win_lo = g + self.window_start(f) * tpf
        win_hi = win_lo + self.span * tpf
        ranges = [(0, win_hi)] if win_lo == g else [(0, g), (win_lo, win_hi)]
        return [(kb, end) for lo, end in ranges for kb in range(lo, end, tile)]

    def pairs(self) -> Tuple[int, int]:
        """(query, key) pairs the function computes: (video queries' band,
        global queries' full rows)."""
        vid = self.n_frames * self.tokens_per_frame
        return vid * (self.global_len + self.span * self.tokens_per_frame), self.global_len * (self.global_len + vid)

    def shard(self, frame_offset: int, local_frames: int) -> "BandGeometry":
        """The geometry of one sequence-parallel shard of video-query frames,
        ``local_frames`` frames from global frame ``frame_offset``: ``1 <=
        F_loc <= F`` and ``0 <= frame_offset``.  Frames at or past F are
        ring-padding dummy frames; on a ring with more ranks than frames
        (F_loc = 1) the ranks past F hold one dummy frame each."""
        f = self.n_frames
        if not 1 <= local_frames <= f:
            raise ValueError(f"a shard holds 1 to F={f} frames, got {local_frames}")
        if frame_offset < 0:
            raise ValueError(f"frame_offset must be >= 0, got {frame_offset}")
        return self._replace(frame_offset=frame_offset, local_frames=local_frames)

    def real_frames(self) -> int:
        """How many of the shard's frames lie inside the clip."""
        return max(0, min(self.local_frames, self.n_frames - self.frame_offset))

    def shard_pairs(self) -> int:
        """(query, key) pairs of the shard's real frames: its share of the
        video queries' band."""
        tpf = self.tokens_per_frame
        return self.real_frames() * tpf * (self.global_len + self.span * tpf)


def ring_shards(n_frames: int, ring: int) -> Tuple[int, int]:
    """(F_pad, F_loc): the frame count padded to a multiple of the ring, and
    the frames of each rank's shard (``s2v_tpu/parallel/sp_attention.py:248-249``);
    rank r's shard starts at frame r·F_loc."""
    f_pad = -(-n_frames // ring) * ring
    return f_pad, f_pad // ring


def band_geometry(seq_len: int, global_len: int, tokens_per_frame: int, window_frames: int) -> BandGeometry:
    """Raise on a geometry the windowed functions do not take: no global
    segment (``banded_attention.py:178-185``), a ragged video segment
    (``:65-66``), a negative window."""
    if global_len <= 0:
        raise ValueError(f"banded attention needs global_len > 0 (got {global_len}); the [text | ref] "
                         f"prefix is the exact-attention segment")
    if tokens_per_frame <= 0 or window_frames < 0:
        raise ValueError(f"tokens_per_frame must be > 0 and window_frames >= 0, got {tokens_per_frame}, "
                         f"{window_frames}")
    n_frames = (seq_len - global_len) // tokens_per_frame
    if n_frames < 1 or global_len + n_frames * tokens_per_frame != seq_len:
        raise ValueError(f"ragged video segment: S={seq_len} is not G={global_len} + F x {tokens_per_frame}")
    return BandGeometry(global_len, tokens_per_frame, n_frames, window_frames,
                        min(2 * window_frames + 1, n_frames), 0, n_frames)


def band_mask(geo: BandGeometry, rows: torch.Tensor, seq_len: int) -> torch.Tensor:
    """``[len(rows), S]`` bool, True where query row ``rows[i]`` attends the
    key (``s2v_tpu/ops/windowed_attention.py:104-108``)."""
    keys = torch.arange(seq_len, device=rows.device)
    k_frame = torch.div(keys - geo.global_len, geo.tokens_per_frame, rounding_mode="floor")  # < 0: global
    q_frame = torch.div(rows - geo.global_len, geo.tokens_per_frame, rounding_mode="floor")
    start = (q_frame - geo.window).clamp(0, geo.n_frames - geo.span)[:, None]
    in_window = (k_frame[None] >= start) & (k_frame[None] < start + geo.span)
    return (q_frame[:, None] < 0) | (k_frame[None] < 0) | in_window


def _check_qkv(q, k, v) -> None:
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q, k, v must be one [B, S, H, d] shape, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")


def banded_flash_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    global_len: int,
    tokens_per_frame: int,
    window_frames: int,
    scale: Optional[float] = None,
    return_lse: bool = False,
):
    """The plain PyTorch version: fp32 masked softmax, chunked over queries
    (``REFERENCE_CHUNK`` rows at a time), logits scaled in fp32 after the
    product.  Returns o ``[B, S, H, d]`` in q's dtype (and the natural-log
    lse ``[B, H, S]`` fp32)."""
    _check_qkv(q, k, v)
    b, s, h, d = q.shape
    geo = band_geometry(s, global_len, tokens_per_frame, window_frames)
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    kf = k.float().permute(0, 2, 3, 1)  # [B, H, d, S]
    vf = v.float().transpose(1, 2)  # [B, H, S, d]
    outs, lses = [], []
    for c0 in range(0, s, REFERENCE_CHUNK):
        rows = torch.arange(c0, min(c0 + REFERENCE_CHUNK, s), device=q.device)
        qc = q[:, c0:c0 + REFERENCE_CHUNK].float().transpose(1, 2)  # [B, H, chunk, d]
        logits = (torch.matmul(qc, kf) * scale).masked_fill(~band_mask(geo, rows, s), float("-inf"))
        m = logits.amax(-1, keepdim=True)
        p = torch.exp(logits - m)
        l = p.sum(-1, keepdim=True)
        outs.append((torch.matmul(p, vf) / l).transpose(1, 2).to(q.dtype))
        lses.append((m + torch.log(l))[..., 0])
    o = torch.cat(outs, dim=1)
    return (o, torch.cat(lses, dim=-1)) if return_lse else o


def check_banded_kernel_inputs(q, k, v) -> None:
    """Raise unless the CUDA kernel takes these tensors: one ``[B, S, H, d]``
    shape, and what B1's kernel requires (bf16, fp16 or fp32, d = 64, 16-byte
    aligned rows, B·H ≤ 65535).  Reads only metadata (testable on meta
    tensors)."""
    _check_qkv(q, k, v)
    check_kernel_inputs(q, k, v)


def launch_banded(q, k, v, o, lse, geo: BandGeometry, scale: float) -> None:
    """One launch of the banded kernel: the video rows of ``o`` (and of
    ``lse``, a contiguous ``[B, H, S]`` fp32 tensor, or None)."""
    b, s, h, _ = q.shape
    if q.dtype == torch.float32:
        g_len = geo.global_len
        attention_f32.launch_fwd(q[:, g_len:], k, v, o[:, g_len:], None if lse is None else lse[..., g_len:],
                                 None, None, scale * LOG2E, False, band=geo)
    else:
        strides = [st for t in (q, k, v, o) for st in t.stride()[:3]]
        native.launch(LIB, ENTRY[q.dtype], q.device, ptr(q), ptr(k), ptr(v), ptr(o), ptr(lse), b, h, s,
                      geo.global_len, geo.tokens_per_frame, geo.n_frames, geo.span, geo.window, *strides,
                      scale * LOG2E)
    native.count("banded_flash_attention", q.dtype)


def _banded_flash_attention_cuda(q, k, v, geo: BandGeometry, scale, return_lse):
    check_banded_kernel_inputs(q, k, v)
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k, v must be on one device")
    b, s, h, d = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    g_len = geo.global_len
    o = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device) if return_lse else None
    launch_banded(q, k, v, o, lse, geo, scale)
    glob = flash_attention(q[:, :g_len], k, v, scale=scale, return_lse=return_lse, softmax_mode="online")
    if return_lse:
        o[:, :g_len].copy_(glob[0])
        lse[..., :g_len].copy_(glob[1])
        return o, lse
    o[:, :g_len].copy_(glob)
    return o


def banded_flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    global_len: int,
    tokens_per_frame: int,
    window_frames: int,
    scale: Optional[float] = None,
    return_lse: bool = False,
):
    """Sliding-temporal-window attention.  q/k/v ``[B, S, H, d]`` in
    ``[text | ref | video]`` order with ``S = global_len + F ·
    tokens_per_frame``; returns ``[B, S, H, d]`` in q's dtype, plus the fp32
    lse ``[B, H, S]`` when ``return_lse`` (the training residual of
    :func:`s2v_torch.kernels.banded_attention_bwd.banded_flash_attention_bwd`).

    CPU tensors take the plain version; CUDA tensors launch the kernels or
    raise (bf16, fp16 or fp32, and d = 64 only)."""
    _check_qkv(q, k, v)
    geo = band_geometry(q.shape[1], global_len, tokens_per_frame, window_frames)
    devices = {t.device.type for t in (q, k, v)}
    if devices == {"cpu"}:
        return banded_flash_attention_reference(q, k, v, global_len, tokens_per_frame, window_frames, scale,
                                                return_lse)
    if devices == {"cuda"}:
        return _banded_flash_attention_cuda(q, k, v, geo, scale, return_lse)
    raise ValueError(f"banded_flash_attention needs q, k, v all on the CPU or all on CUDA, got {devices}")


# ---------------------------------------------------------------------------
# B6: one sequence-parallel shard of video-query frames
# ---------------------------------------------------------------------------


def local_geometry(q_vid, k_full, v_full, global_len: int, tokens_per_frame: int, window_frames: int,
                   frame_offset, n_frames_total: int) -> BandGeometry:
    """The shard's geometry from the shapes; raises on what B6/B7 do not
    take: a ragged local segment, K/V that are not the full sequence, a
    shard outside the ring-padded clip (:meth:`BandGeometry.shard`)."""
    if q_vid.dim() != 4 or k_full.dim() != 4 or k_full.shape != v_full.shape:
        raise ValueError(f"q_vid must be [B, F_loc·tpf, H, d] and k, v one [B, S, H, d] shape; got "
                         f"{tuple(q_vid.shape)}, {tuple(k_full.shape)}, {tuple(v_full.shape)}")
    if q_vid.shape[0] != k_full.shape[0] or q_vid.shape[2:] != k_full.shape[2:]:
        raise ValueError(f"q_vid {tuple(q_vid.shape)} does not match k {tuple(k_full.shape)}")
    geo = band_geometry(k_full.shape[1], global_len, tokens_per_frame, window_frames)
    if geo.n_frames != n_frames_total:
        raise ValueError(f"k/v must be the full sequence G + {n_frames_total} x {tokens_per_frame}; "
                         f"S={k_full.shape[1]}")
    local_frames = q_vid.shape[1] // tokens_per_frame
    if local_frames * tokens_per_frame != q_vid.shape[1]:
        raise ValueError(f"ragged local video segment: {q_vid.shape[1]} rows, {tokens_per_frame} per frame")
    return geo.shard(int(torch.as_tensor(frame_offset).reshape(-1)[0]), local_frames)


def banded_flash_attention_local_reference(
    q_vid: torch.Tensor,
    k_full: torch.Tensor,
    v_full: torch.Tensor,
    global_len: int,
    tokens_per_frame: int,
    window_frames: int,
    frame_offset,
    n_frames_total: int,
    scale: Optional[float] = None,
    return_lse: bool = False,
):
    """The plain PyTorch version of B6: fp32 masked softmax chunked over the
    shard's query rows, which sit at the global rows ``G + frame_offset·tpf +
    i`` of :func:`band_mask` (dummy frames past F take the last window, as
    the kernel's clamp does).  Returns o ``[B, F_loc·tpf, H, d]`` in q's
    dtype (and the natural-log lse ``[B, H, F_loc·tpf]`` fp32)."""
    geo = local_geometry(q_vid, k_full, v_full, global_len, tokens_per_frame, window_frames, frame_offset,
                         n_frames_total)
    b, sq, h, d = q_vid.shape
    s = k_full.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    row0 = global_len + geo.frame_offset * tokens_per_frame
    kf = k_full.float().permute(0, 2, 3, 1)  # [B, H, d, S]
    vf = v_full.float().transpose(1, 2)  # [B, H, S, d]
    outs, lses = [], []
    for c0 in range(0, sq, REFERENCE_CHUNK):
        rows = torch.arange(row0 + c0, row0 + min(c0 + REFERENCE_CHUNK, sq), device=q_vid.device)
        qc = q_vid[:, c0:c0 + REFERENCE_CHUNK].float().transpose(1, 2)  # [B, H, chunk, d]
        logits = (torch.matmul(qc, kf) * scale).masked_fill(~band_mask(geo, rows, s), float("-inf"))
        m = logits.amax(-1, keepdim=True)
        p = torch.exp(logits - m)
        l = p.sum(-1, keepdim=True)
        outs.append((torch.matmul(p, vf) / l).transpose(1, 2).to(q_vid.dtype))
        lses.append((m + torch.log(l))[..., 0])
    o = torch.cat(outs, dim=1)
    return (o, torch.cat(lses, dim=-1)) if return_lse else o


def launch_banded_local(q_vid, k, v, o, lse, geo: BandGeometry, scale: float) -> None:
    """One launch of B6: the shard's rows of ``o`` (and of ``lse``, a
    contiguous ``[B, H, F_loc·tpf]`` fp32 tensor, or None)."""
    b, _, h, _ = q_vid.shape
    if q_vid.dtype == torch.float32:
        attention_f32.launch_fwd(q_vid, k, v, o, lse, None, None, scale * LOG2E, False, band=geo)
    else:
        strides = [st for t in (q_vid, k, v, o) for st in t.stride()[:3]]
        native.launch(LIB, LOCAL_ENTRY[q_vid.dtype], q_vid.device, ptr(q_vid), ptr(k), ptr(v), ptr(o), ptr(lse),
                      b, h, geo.global_len, geo.tokens_per_frame, geo.n_frames, geo.span, geo.window,
                      geo.frame_offset, geo.local_frames, *strides, scale * LOG2E)
    native.count("banded_flash_attention_local", q_vid.dtype)


def banded_flash_attention_local(
    q_vid: torch.Tensor,
    k_full: torch.Tensor,
    v_full: torch.Tensor,
    global_len: int,
    tokens_per_frame: int,
    window_frames: int,
    frame_offset,
    n_frames_total: int,
    scale: Optional[float] = None,
    return_lse: bool = False,
):
    """Banded attention for one shard of video-frame queries against the
    full key sequence (the sequence-parallel building block).

    ``q_vid`` ``[B, F_loc·tpf, H, d]``: the video rows of this shard's frames
    only.  ``k_full``/``v_full`` ``[B, S, H, d]`` with ``S = global_len +
    n_frames_total·tpf``.  ``frame_offset`` (an int, or a one-element
    tensor as JAX passes it) is the shard's first global frame.  Returns
    ``[B, F_loc·tpf, H, d]`` in q's dtype, plus the fp32 lse ``[B, H,
    F_loc·tpf]`` when ``return_lse`` (the residual of
    :func:`s2v_torch.kernels.banded_attention_bwd.banded_flash_attention_local_bwd`).

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise (bf16, fp16 or fp32, and d = 64 only)."""
    geo = local_geometry(q_vid, k_full, v_full, global_len, tokens_per_frame, window_frames, frame_offset,
                         n_frames_total)
    devices = {t.device.type for t in (q_vid, k_full, v_full)}
    if devices == {"cpu"}:
        return banded_flash_attention_local_reference(q_vid, k_full, v_full, global_len, tokens_per_frame,
                                                      window_frames, geo.frame_offset, n_frames_total, scale,
                                                      return_lse)
    if devices != {"cuda"}:
        raise ValueError(f"banded_flash_attention_local needs q, k, v all on the CPU or all on CUDA, got {devices}")
    check_kernel_inputs(q_vid, k_full, v_full)
    if k_full.device != q_vid.device or v_full.device != q_vid.device:
        raise ValueError("q, k, v must be on one device")
    b, sq, h, d = q_vid.shape
    o = torch.empty((b, sq, h, d), dtype=q_vid.dtype, device=q_vid.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q_vid.device) if return_lse else None
    launch_banded_local(q_vid, k_full, v_full, o, lse, geo, 1.0 / math.sqrt(d) if scale is None else scale)
    return (o, lse) if return_lse else o


# ---------------------------------------------------------------------------
# The CUDA kernel's schedule, emulated
# ---------------------------------------------------------------------------


def _banded_fwd_schedule(q_rows, k, v, geo: BandGeometry, scale: float):
    """The banded kernel on the query rows ``q_rows`` ``[B, F_loc·tpf, H, d]``
    of frames ``geo.frame_offset ..``: per 128-row query tile inside a frame,
    the key tiles of :meth:`BandGeometry.key_tiles` in order, with the
    kernel's online softmax in log2 units (running max, rescale), P rounded to
    the input type (bf16, or fp16 for fp16 inputs) for P·V and the row sums of
    the unrounded P.  Returns o ``[B, H,
    rows, d]`` and the natural-log lse ``[B, H, rows]``, fp32."""
    c = scale * LOG2E
    low = torch.float16 if q_rows.dtype == torch.float16 else torch.bfloat16
    qf = q_rows.float().transpose(1, 2)  # [B, H, rows, d]
    kf, vf = k.float().transpose(1, 2), v.float().transpose(1, 2)  # [B, H, S, d]
    tpf = geo.tokens_per_frame
    outs, lses = [], []
    for fl in range(geo.local_frames):
        tiles = geo.key_tiles(geo.frame_offset + fl, KERNEL_KEY_TILE)
        frame_end = (fl + 1) * tpf
        for r0 in range(fl * tpf, frame_end, KERNEL_QUERY_TILE):
            qt = qf[:, :, r0:min(r0 + KERNEL_QUERY_TILE, frame_end)]
            m = qt.new_full(qt.shape[:-1], -1e30)
            l = qt.new_zeros(qt.shape[:-1])
            o = torch.zeros_like(qt)
            for kb, kend in tiles:
                ke = min(kb + KERNEL_KEY_TILE, kend)
                s = torch.matmul(qt, kf[:, :, kb:ke].transpose(-1, -2))
                m_new = torch.maximum(m, s.amax(-1) * c)
                alpha = torch.exp2(m - m_new)
                p = torch.exp2(s * c - m_new[..., None])
                l = l * alpha + p.sum(-1)
                o = o * alpha[..., None] + torch.matmul(p.to(low).float(), vf[:, :, kb:ke])
                m = m_new
            outs.append(o / l[..., None])
            lses.append(m * LN2 + torch.log(l))
    return torch.cat(outs, dim=2), torch.cat(lses, dim=-1)


def banded_flash_attention_blocked(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    global_len: int,
    tokens_per_frame: int,
    window_frames: int,
    scale: Optional[float] = None,
    return_lse: bool = False,
    frame_offset=None,
    n_frames_total: Optional[int] = None,
):
    """The CUDA kernel's schedule, emulated in PyTorch on any device (see
    :func:`_banded_fwd_schedule`).  Without ``frame_offset``, B4's contract
    (:func:`banded_flash_attention`; the global queries through B1's plain
    version in the online mode, as the CUDA path sends them to B1); with it,
    B6's (:func:`banded_flash_attention_local`, ``q`` the shard's video rows).
    The card tests and the smoke hold the kernel to it; the CPU tests hold it
    to the plain versions and to JAX.  Nothing on the main path calls it."""
    d = q.shape[-1]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if frame_offset is None:
        _check_qkv(q, k, v)
        geo = band_geometry(q.shape[1], global_len, tokens_per_frame, window_frames)
        g_len = geo.global_len
        o_vid, lse_vid = _banded_fwd_schedule(q[:, g_len:], k, v, geo, scale)
        o_glob, lse_glob = flash_attention_reference(q[:, :g_len], k, v, scale=scale, return_lse=True)
        o = torch.cat([o_glob, o_vid.transpose(1, 2).to(q.dtype)], dim=1)
        lse = torch.cat([lse_glob, lse_vid], dim=-1)
    else:
        geo = local_geometry(q, k, v, global_len, tokens_per_frame, window_frames, frame_offset, n_frames_total)
        o, lse = _banded_fwd_schedule(q, k, v, geo, scale)
        o = o.transpose(1, 2).to(q.dtype)
    return (o, lse) if return_lse else o
