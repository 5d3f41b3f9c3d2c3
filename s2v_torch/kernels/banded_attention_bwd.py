"""Kernel B5: the backward of banded (sliding temporal window) flash
attention, a CUDA C++ kernel for Hopper.

Replaces ``s2v_tpu/ops/pallas/banded_attention_bwd.py::banded_flash_attention_bwd``.
Given the forward's q, k, v, o, its lse (natural log, ``[B, H, S]``) and dO
of :func:`s2v_torch.kernels.banded_attention.banded_flash_attention`, it
returns dq, dk, dv.  On CUDA:

  * the global queries' part is one B2 call
    (``s2v_torch.kernels.flash_attention_bwd``) on the views ``q[:, :G]``,
    ``o[:, :G]``, ``dO[:, :G]`` against the full k, v: their dq, and their
    share of dk and dv over every key;
  * the video queries' part is one launch of the three kernels of
    ``s2v_torch/csrc/banded_attention_bwd.cu`` (on ``csrc/hopper.cuh`` and
    ``csrc/band.cuh``): a pre-pass (D = rowsum(dO ∘ o) and lse·log2 e into
    a padded fp32 workspace the wrapper allocates), a banded dq kernel (one
    block per 128 queries of one frame, K/V streamed over the global keys
    and the window) and a dk/dv kernel (one block per 128 keys, q/dO
    streamed over every video query for a global key tile, over the inverse
    band for a video key tile), warp-specialised with TMA, mbarriers and
    ``wgmma``, compiled with ``nvcc`` for ``sm_90a`` into ``build/`` on the
    first CUDA call and bound with ``ctypes``.  Every output is written by
    one block, so results are the same bit for bit on every run;
  * dk and dv are the sum of the two parts, as in
    ``banded_attention_bwd.py:364-366``.

CPU tensors take :func:`banded_flash_attention_bwd_reference`, the plain
PyTorch version.  :func:`banded_flash_attention_bwd_blocked` emulates the
kernels' schedule on any device.  ``banded_flash_attention_bwd.launches``
counts calls that launched the banded kernels.

Kernel B7, :func:`banded_flash_attention_local_bwd`, replaces
``s2v_tpu/ops/pallas/banded_attention_bwd.py::banded_flash_attention_local_bwd``:
the backward of B6 (``banded_attention.py::banded_flash_attention_local``) for
one sequence-parallel shard of video-query frames.  It returns the shard's dq
``[B, F_loc·tpf, H, d]`` and the full-extent partial dk, dv ``[B, S, H, d]``
from the shard's queries only (the global queries' part is the SP wrapper's,
``s2v_torch/parallel/sp_attention.py``).  It is one launch of the same
three CUDA kernels through its own C entry point
``s2v_banded_attention_local_bwd``, at the shard's runtime frame offset;
:func:`banded_flash_attention_local_bwd_reference` is its plain version and
``banded_flash_attention_local_bwd.launches`` its own count.  Frames at or
past F (ring-padding dummy frames) contribute exactly nothing: their dq rows
are zero and no dk/dv walk reaches them, whatever their q, dO and lse hold.

Bound on an H100 SXM at the training shape (B=1, H=48, G=1,576, tpf=1,350,
F=13, w=2, d=64): the five products over the band are 10·B·H·d·(17,550 ×
8,326) = 4.49·10¹² operations (4.54 ms at 989 TFLOP/s bf16),
the global queries' B2 call 9.3·10¹¹ (0.94 ms); both compute-bound.  B7 at
world size 1 does the banded kernels' work; a shard of a P-rank ring does its
real frames' share (``BandGeometry.shard_pairs``).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from s2v_torch.kernels.banded_attention import (
    BandGeometry,
    band_geometry,
    band_mask,
    check_banded_kernel_inputs,
    local_geometry,
)
from s2v_torch.kernels.flash_attention import LOG2E, check_kernel_inputs, check_kernel_tensor
from s2v_torch.kernels.flash_attention_bwd import (
    flash_attention_bwd,
    flash_attention_bwd_blocked,
    masked_bwd_reference,
    row_delta,
)
from s2v_torch.utils import native_build

SOURCE = native_build.CSRC_DIR / "banded_attention_bwd.cu"
# rows of each tile the kernels stream (keys in the dq kernel, queries in
# the dk/dv kernel); a block owns 128 resident rows
KERNEL_TILE_ROWS = 64
# the parts of one call, a bit mask of the C entry points
PART_PREPASS, PART_DQ, PART_DKV = 1, 2, 4
ALL_PARTS = PART_PREPASS | PART_DQ | PART_DKV
_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(native_build.build_one(SOURCE)))
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        pointers = [vp] * 8 + [i32] + [vp] * 3  # q, k, v, o, dO, lse, the workspace and its rows, dq, dk, dv
        fn = lib.s2v_banded_attention_bwd
        fn.argtypes = pointers + [i32] * 8 + [i64] * 24 + [ctypes.c_float, i32, vp]
        fn.restype = i32
        local = lib.s2v_banded_attention_local_bwd
        local.argtypes = pointers + [i32] * 9 + [i64] * 24 + [ctypes.c_float, i32, vp]
        local.restype = i32
        _lib = lib
    return _lib


def _check_shapes(q, k, v, o, lse, g) -> None:
    if q.dim() != 4 or any(t.shape != q.shape for t in (k, v, o, g)):
        raise ValueError(f"q, k, v, o, dO must be one [B, S, H, d] shape; q is {tuple(q.shape)}")
    b, s, h, _ = q.shape
    if tuple(lse.shape) != (b, h, s):
        raise ValueError(f"lse must be [B, H, S] = {(b, h, s)}, got {tuple(lse.shape)}")


def _check_lse(lse, what: str) -> None:
    if lse.dtype != torch.float32:
        raise ValueError(f"{what} kernels take an fp32 lse; got {lse.dtype}")
    if not lse.is_contiguous():
        raise ValueError(f"{what} kernels take a contiguous lse; strides {lse.stride()}")


def check_banded_bwd_kernel_inputs(q, k, v, o, lse, g) -> None:
    """Raise unless the CUDA kernels take these tensors: q/k/v/o/dO as
    :func:`check_banded_kernel_inputs` requires, lse fp32, contiguous ``[B,
    H, S]`` (the kernels compute D themselves).  Reads only metadata
    (testable on meta tensors)."""
    _check_shapes(q, k, v, o, lse, g)
    check_banded_kernel_inputs(q, k, v)
    check_kernel_tensor("o", o)
    check_kernel_tensor("dO", g)
    _check_lse(lse, "banded_flash_attention_bwd")


def banded_flash_attention_bwd_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    lse: torch.Tensor,
    g: torch.Tensor,
    global_len: int,
    tokens_per_frame: int,
    window_frames: int,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain PyTorch version: the chunked fp32 backward of
    ``flash_attention_bwd_reference`` with P recomputed from ``lse`` and set
    to 0 outside the band.  Returns dq, dk, dv in q's, k's and v's dtypes."""
    _check_shapes(q, k, v, o, lse, g)
    geo = band_geometry(q.shape[1], global_len, tokens_per_frame, window_frames)
    return masked_bwd_reference(q, k, v, o, lse, g, scale, mask_rows=lambda rows: band_mask(geo, rows, q.shape[1]))


def banded_bwd_workspace(q: torch.Tensor, query_rows: int) -> torch.Tensor:
    """The kernels' fp32 workspace ``[2, B·H, ws_rows]`` (lse·log2 e and D of
    the call's ``query_rows`` video query rows), written by the pre-pass:
    ``ws_rows`` is a multiple of the tile with room past the last row for a
    tile's copy from a 16-byte boundary (``query_rows + 68`` at least)."""
    b, _, h, _ = q.shape
    tile = KERNEL_TILE_ROWS
    ws_rows = -(-(query_rows + tile + 4) // tile) * tile
    return torch.empty((2, b * h, ws_rows), dtype=torch.float32, device=q.device)


def _pointers_and_strides(q, k, v, o, g, lse, workspace, dq, dk, dv):
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    pointers = [ptr(t) for t in (q, k, v, o, g, lse, workspace[0], workspace[1])]
    pointers += [workspace.shape[2], ptr(dq), ptr(dk), ptr(dv)]
    strides = [st for t in (q, k, v, o, g, dq, dk, dv) for st in t.stride()[:3]]
    return pointers, strides


def launch_banded_bwd(q, k, v, o, g, lse, dq, dk, dv, geo: BandGeometry, scale: float, workspace,
                      parts: int = ALL_PARTS) -> None:
    """Launch ``parts`` of one banded backward (all three for a call; the
    smoke times them one at a time on a workspace a full launch has filled):
    dq at the video rows, dk and dv of the video queries' part at every row."""
    b, s, h, _ = q.shape
    pointers, strides = _pointers_and_strides(q, k, v, o, g, lse, workspace, dq, dk, dv)
    err = _library().s2v_banded_attention_bwd(
        *pointers, b, h, s, geo.global_len, geo.tokens_per_frame, geo.n_frames, geo.span, geo.window,
        *strides, ctypes.c_float(scale), int(parts), ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream),
    )
    if err != 0:
        raise RuntimeError(f"banded_flash_attention_bwd kernel launch failed: {native_build.launch_error(err)}")
    banded_flash_attention_bwd.launches += 1


def _banded_flash_attention_bwd_cuda(q, k, v, o, lse, g, geo, scale):
    check_banded_bwd_kernel_inputs(q, k, v, o, lse, g)
    for t in (k, v, o, lse, g):
        if t.device != q.device:
            raise ValueError("q, k, v, o, lse, dO must be on one device")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    g_len = geo.global_len
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=k.dtype, device=q.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=q.device)
    workspace = banded_bwd_workspace(q, geo.n_frames * geo.tokens_per_frame)
    launch_banded_bwd(q, k, v, o, g, lse, dq, dk, dv, geo, scale, workspace)
    dq_glob, dk_glob, dv_glob = flash_attention_bwd(q[:, :g_len], k, v, o[:, :g_len],
                                                    lse[..., :g_len].contiguous(), g[:, :g_len], scale)
    dq[:, :g_len].copy_(dq_glob)
    dk += dk_glob
    dv += dv_glob
    return dq, dk, dv


def banded_flash_attention_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    lse: torch.Tensor,
    g: torch.Tensor,
    global_len: int,
    tokens_per_frame: int,
    window_frames: int,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of ``o = banded_flash_attention(q, k, v, ...)``; every
    tensor ``[B, S, H, d]`` but lse ``[B, H, S]`` fp32 (the forward's, natural
    log), g = dL/do.

    CPU tensors take the plain version; CUDA tensors launch the kernels or
    raise (bf16 and d = 64 only)."""
    _check_shapes(q, k, v, o, lse, g)
    geo = band_geometry(q.shape[1], global_len, tokens_per_frame, window_frames)
    devices = {t.device.type for t in (q, k, v, o, lse, g)}
    if devices == {"cpu"}:
        return banded_flash_attention_bwd_reference(q, k, v, o, lse, g, global_len, tokens_per_frame,
                                                    window_frames, scale)
    if devices == {"cuda"}:
        return _banded_flash_attention_bwd_cuda(q, k, v, o, lse, g, geo, scale)
    raise ValueError(f"banded_flash_attention_bwd needs all its inputs on the CPU or all on CUDA, got {devices}")


banded_flash_attention_bwd.launches = 0


# ---------------------------------------------------------------------------
# B7: one sequence-parallel shard of video-query frames
# ---------------------------------------------------------------------------


def _local_geometry(q_vid, k_full, v_full, o_vid, lse_vid, g_vid, global_len, tokens_per_frame, window_frames,
                    frame_offset, n_frames_total):
    geo = local_geometry(q_vid, k_full, v_full, global_len, tokens_per_frame, window_frames, frame_offset,
                         n_frames_total)
    for name, t in (("o", o_vid), ("dO", g_vid)):
        if t.shape != q_vid.shape:
            raise ValueError(f"{name} {tuple(t.shape)} must have q_vid's shape {tuple(q_vid.shape)}")
    b, sq, h, _ = q_vid.shape
    if tuple(lse_vid.shape) != (b, h, sq):
        raise ValueError(f"lse must be [B, H, F_loc·tpf] = {(b, h, sq)}, got {tuple(lse_vid.shape)}")
    return geo


def banded_flash_attention_local_bwd_reference(
    q_vid: torch.Tensor,
    k_full: torch.Tensor,
    v_full: torch.Tensor,
    o_vid: torch.Tensor,
    lse_vid: torch.Tensor,
    g_vid: torch.Tensor,
    global_len: int,
    tokens_per_frame: int,
    window_frames: int,
    frame_offset,
    n_frames_total: int,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of B7: the chunked fp32 backward of
    ``masked_bwd_reference`` with the shard's rows at the global rows ``G +
    frame_offset·tpf + i`` of :func:`band_mask`, and dummy frames' rows masked
    out entirely (P = 0: zero dq, no dk/dv).  Returns dq ``[B, F_loc·tpf, H,
    d]`` and the partial dk, dv ``[B, S, H, d]`` in q's, k's and v's dtypes."""
    geo = _local_geometry(q_vid, k_full, v_full, o_vid, lse_vid, g_vid, global_len, tokens_per_frame,
                          window_frames, frame_offset, n_frames_total)
    s = k_full.shape[1]
    row0 = global_len + geo.frame_offset * tokens_per_frame
    real_rows = geo.real_frames() * tokens_per_frame

    def mask_rows(rows):
        return band_mask(geo, row0 + rows, s) & (rows < real_rows)[:, None]

    return masked_bwd_reference(q_vid, k_full, v_full, o_vid, lse_vid, g_vid, scale, mask_rows=mask_rows)


def check_banded_local_bwd_kernel_inputs(q_vid, k_full, v_full, o_vid, lse_vid, g_vid) -> None:
    """Raise unless B7's CUDA kernels take these tensors: q/o/dO and k/v as
    :func:`check_kernel_inputs` requires, lse fp32, contiguous ``[B, H,
    F_loc·tpf]``.  Reads only metadata (testable on meta tensors)."""
    check_kernel_inputs(q_vid, k_full, v_full)
    check_kernel_tensor("o", o_vid)
    check_kernel_tensor("dO", g_vid)
    _check_lse(lse_vid, "banded_flash_attention_local_bwd")


def launch_banded_local_bwd(q_vid, k, v, o_vid, g_vid, lse_vid, dq, dk, dv, geo: BandGeometry, scale: float,
                            workspace, parts: int = ALL_PARTS) -> None:
    """Launch ``parts`` of one B7 backward: the shard's dq, and its partial
    dk and dv at every row of the full sequence."""
    b, _, h, _ = q_vid.shape
    pointers, strides = _pointers_and_strides(q_vid, k, v, o_vid, g_vid, lse_vid, workspace, dq, dk, dv)
    err = _library().s2v_banded_attention_local_bwd(
        *pointers, b, h, geo.global_len, geo.tokens_per_frame, geo.n_frames, geo.span, geo.window,
        geo.frame_offset, geo.local_frames, *strides, ctypes.c_float(scale), int(parts),
        ctypes.c_void_p(torch.cuda.current_stream(q_vid.device).cuda_stream),
    )
    if err != 0:
        raise RuntimeError(f"banded_flash_attention_local_bwd kernel launch failed: {native_build.launch_error(err)}")
    banded_flash_attention_local_bwd.launches += 1


def banded_flash_attention_local_bwd(
    q_vid: torch.Tensor,
    k_full: torch.Tensor,
    v_full: torch.Tensor,
    o_vid: torch.Tensor,
    lse_vid: torch.Tensor,
    g_vid: torch.Tensor,
    global_len: int,
    tokens_per_frame: int,
    window_frames: int,
    frame_offset,
    n_frames_total: int,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Backward of :func:`s2v_torch.kernels.banded_attention.banded_flash_attention_local`:
    ``q_vid``, ``o_vid`` (its output), ``g_vid`` (dL/do) ``[B, F_loc·tpf, H,
    d]``, ``lse_vid`` ``[B, H, F_loc·tpf]`` fp32 (its natural-log lse),
    ``k_full``/``v_full`` ``[B, S, H, d]``.  Returns (dq ``[B, F_loc·tpf, H,
    d]``, dk, dv ``[B, S, H, d]``): dk and dv are partials from this shard's
    queries only, to be summed over the ranks; the global queries' share is
    not included.

    CPU tensors take the plain version; CUDA tensors launch the kernels or
    raise (bf16 and d = 64 only)."""
    geo = _local_geometry(q_vid, k_full, v_full, o_vid, lse_vid, g_vid, global_len, tokens_per_frame,
                          window_frames, frame_offset, n_frames_total)
    devices = {t.device.type for t in (q_vid, k_full, v_full, o_vid, lse_vid, g_vid)}
    if devices == {"cpu"}:
        return banded_flash_attention_local_bwd_reference(q_vid, k_full, v_full, o_vid, lse_vid, g_vid, global_len,
                                                          tokens_per_frame, window_frames, geo.frame_offset,
                                                          n_frames_total, scale)
    if devices != {"cuda"}:
        raise ValueError(f"banded_flash_attention_local_bwd needs all its inputs on the CPU or all on CUDA, "
                         f"got {devices}")
    check_banded_local_bwd_kernel_inputs(q_vid, k_full, v_full, o_vid, lse_vid, g_vid)
    for t in (k_full, v_full, o_vid, lse_vid, g_vid):
        if t.device != q_vid.device:
            raise ValueError("q, k, v, o, lse, dO must be on one device")
    if scale is None:
        scale = 1.0 / math.sqrt(q_vid.shape[-1])
    dq = torch.empty(q_vid.shape, dtype=q_vid.dtype, device=q_vid.device)
    dk = torch.empty(k_full.shape, dtype=k_full.dtype, device=q_vid.device)
    dv = torch.empty(v_full.shape, dtype=v_full.dtype, device=q_vid.device)
    launch_banded_local_bwd(q_vid, k_full, v_full, o_vid, g_vid, lse_vid, dq, dk, dv, geo, scale,
                            banded_bwd_workspace(q_vid, q_vid.shape[1]))
    return dq, dk, dv


banded_flash_attention_local_bwd.launches = 0


# ---------------------------------------------------------------------------
# The CUDA kernels' schedule, emulated
# ---------------------------------------------------------------------------


def _banded_bwd_schedule(q_rows, k, v, o_rows, lse_rows, g_rows, geo: BandGeometry, scale: float):
    """The banded kernels on the query rows ``q_rows`` ``[B, F_loc·tpf, H, d]``
    of frames ``geo.frame_offset ..`` (with their o, dO and lse ``[B, H,
    F_loc·tpf]``), fp32 with P and dS rounded to bf16 where the kernels feed
    them to ``wgmma`` and the logits in log2 units against ``lse·log2 e``:

      * the dq kernel: per query frame (its 128-row tiles share one walk), dq
        summed over the 64-key tiles of :meth:`BandGeometry.key_tiles` in
        order; dummy frames' dq is zero;
      * the dk/dv kernel: per key range (the global keys; each key frame:
        its 128-key tiles share one walk), dk and dv summed over 64-query
        tiles in order from the first of its query rows (every real video
        row for global keys, the inverse band's frames for a key frame).

    Returns dq ``[B, H, rows, d]`` and the video queries' dk, dv ``[B, H, S,
    d]``, fp32, scaled."""
    c = scale * LOG2E
    tile = KERNEL_TILE_ROWS
    qf, gf = q_rows.float().transpose(1, 2), g_rows.float().transpose(1, 2)  # [B, H, rows, d]
    kf, vf = k.float().transpose(1, 2), v.float().transpose(1, 2)  # [B, H, S, d]
    delta = row_delta(o_rows, g_rows)  # [B, H, rows], the pre-pass
    lse2 = lse_rows.float() * LOG2E
    bf16 = lambda x: x.to(torch.bfloat16).float()  # noqa: E731
    g_len, tpf, off = geo.global_len, geo.tokens_per_frame, geo.frame_offset
    real = geo.real_frames()

    dq = torch.zeros_like(qf)
    for fl in range(real):
        r0, r1 = fl * tpf, (fl + 1) * tpf
        for kb, kend in geo.key_tiles(off + fl, tile):
            kt, vt = kf[:, :, kb:min(kb + tile, kend)], vf[:, :, kb:min(kb + tile, kend)]
            p = torch.exp2(torch.matmul(qf[:, :, r0:r1], kt.transpose(-1, -2)) * c - lse2[:, :, r0:r1, None])
            dp = torch.matmul(gf[:, :, r0:r1], vt.transpose(-1, -2))
            dq[:, :, r0:r1] += torch.matmul(bf16(p * (dp - delta[:, :, r0:r1, None])), kt)

    # (keys, query rows) of each key range: global keys see every real row
    ranges = [(0, g_len, 0, real * tpf)]
    for fk in range(geo.n_frames):
        f_lo, f_hi = geo.inverse_band(fk)
        lo, hi = max(f_lo, off), min(f_hi, off + geo.local_frames - 1)
        q_lo = (lo - off) * tpf
        ranges.append((g_len + fk * tpf, g_len + (fk + 1) * tpf, q_lo, (hi - off + 1) * tpf if hi >= lo else q_lo))
    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    for k0, k1, q_lo, q_hi in ranges:
        for qb in range(q_lo, q_hi, tile):
            qe = min(qb + tile, q_hi)
            qt, gt = qf[:, :, qb:qe], gf[:, :, qb:qe]
            pt = torch.exp2(torch.matmul(kf[:, :, k0:k1], qt.transpose(-1, -2)) * c - lse2[:, :, None, qb:qe])
            dpt = torch.matmul(vf[:, :, k0:k1], gt.transpose(-1, -2))
            dv[:, :, k0:k1] += torch.matmul(bf16(pt), gt)
            dk[:, :, k0:k1] += torch.matmul(bf16(pt * (dpt - delta[:, :, None, qb:qe])), qt)
    return dq * scale, dk * scale, dv


def banded_flash_attention_bwd_blocked(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    lse: torch.Tensor,
    g: torch.Tensor,
    global_len: int,
    tokens_per_frame: int,
    window_frames: int,
    scale: Optional[float] = None,
    frame_offset=None,
    n_frames_total: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The CUDA kernels' schedule, emulated in PyTorch on any device (see
    :func:`_banded_bwd_schedule`).  Without ``frame_offset``, B5's contract
    (:func:`banded_flash_attention_bwd`: the global queries' part through
    B2's emulation ``flash_attention_bwd_blocked``, added to dk and dv in
    their dtypes as the CUDA path adds them); with it, B7's
    (:func:`banded_flash_attention_local_bwd`: the shard's dq and its
    partial dk, dv).  The card tests and the smoke hold the kernels to it;
    the CPU tests hold it to the plain versions and to JAX.  Nothing on the
    main path calls it."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if frame_offset is not None:
        geo = _local_geometry(q, k, v, o, lse, g, global_len, tokens_per_frame, window_frames, frame_offset,
                              n_frames_total)
        dq, dk, dv = _banded_bwd_schedule(q, k, v, o, lse, g, geo, scale)
        return dq.transpose(1, 2).to(q.dtype), dk.transpose(1, 2).to(k.dtype), dv.transpose(1, 2).to(v.dtype)
    _check_shapes(q, k, v, o, lse, g)
    geo = band_geometry(q.shape[1], global_len, tokens_per_frame, window_frames)
    g_len = geo.global_len
    dq, dk, dv = _banded_bwd_schedule(q[:, g_len:], k, v, o[:, g_len:], lse[..., g_len:], g[:, g_len:], geo, scale)
    dq_glob, dk_glob, dv_glob = flash_attention_bwd_blocked(q[:, :g_len], k, v, o[:, :g_len], lse[..., :g_len],
                                                            g[:, :g_len], scale)
    return (torch.cat([dq_glob, dq.transpose(1, 2).to(q.dtype)], dim=1),
            dk.transpose(1, 2).to(k.dtype) + dk_glob, dv.transpose(1, 2).to(v.dtype) + dv_glob)
