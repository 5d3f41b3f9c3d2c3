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
  * the video queries' part is one launch pair of
    ``s2v_torch/csrc/banded_attention_bwd.cu`` (a banded dq kernel, and a
    dk/dv kernel that walks the inverse band for video keys and every video
    query for global keys), compiled with ``nvcc`` for ``sm_90a`` into
    ``build/`` on the first CUDA call and bound with ``ctypes``;
  * dk and dv are the sum of the two parts, as in
    ``banded_attention_bwd.py:364-366``.

CPU tensors take :func:`banded_flash_attention_bwd_reference`, the plain
PyTorch version.  ``banded_flash_attention_bwd.launches`` counts calls that
launched the banded kernel pair.

Kernel B7, :func:`banded_flash_attention_local_bwd`, replaces
``s2v_tpu/ops/pallas/banded_attention_bwd.py::banded_flash_attention_local_bwd``:
the backward of B6 (``banded_attention.py::banded_flash_attention_local``) for
one sequence-parallel shard of video-query frames.  It returns the shard's dq
``[B, F_loc·tpf, H, d]`` and the full-extent partial dk, dv ``[B, S, H, d]``
from the shard's queries only (the global queries' part is the SP wrapper's,
``s2v_torch/parallel/sp_attention.py``).  It is one launch pair of the same
two CUDA kernels through its own C entry point
``s2v_banded_attention_local_bwd``, at the shard's runtime frame offset;
:func:`banded_flash_attention_local_bwd_reference` is its plain version and
``banded_flash_attention_local_bwd.launches`` its own count.  Frames at or
past F (ring-padding dummy frames) contribute exactly nothing: their dq rows
are zero and no dk/dv walk reaches them, whatever their q, dO and lse hold.

Bound on an H100 SXM at the training shape (B=1, H=48, G=1,576, tpf=1,350,
F=13, w=2, d=64): the five products over the band are 10·B·H·d·(17,550 ×
8,326) = 4.49·10¹² operations (4.54 ms at 989 TFLOP/s bf16),
the global queries' B2 call 9.3·10¹¹ (0.94 ms); both compute-bound.  B7 at
world size 1 does the banded pair's work; a shard of a P-rank ring does its
real frames' share (``BandGeometry.shard_pairs``).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from s2v_torch.kernels.banded_attention import band_geometry, band_mask, check_banded_kernel_inputs, local_geometry
from s2v_torch.kernels.flash_attention import check_kernel_inputs, check_kernel_tensor
from s2v_torch.kernels.flash_attention_bwd import flash_attention_bwd, masked_bwd_reference, row_delta
from s2v_torch.utils import native_build

SOURCE = native_build.CSRC_DIR / "banded_attention_bwd.cu"
_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(native_build.build_one(SOURCE)))
        fn = lib.s2v_banded_attention_bwd
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [vp] * 9 + [i32] * 8 + [i64] * 21 + [ctypes.c_float, vp]
        fn.restype = i32
        local = lib.s2v_banded_attention_local_bwd
        local.argtypes = [vp] * 9 + [i32] * 9 + [i64] * 21 + [ctypes.c_float, vp]
        local.restype = i32
        _lib = lib
    return _lib


def _check_shapes(q, k, v, o, lse, g) -> None:
    if q.dim() != 4 or any(t.shape != q.shape for t in (k, v, o, g)):
        raise ValueError(f"q, k, v, o, dO must be one [B, S, H, d] shape; q is {tuple(q.shape)}")
    b, s, h, _ = q.shape
    if tuple(lse.shape) != (b, h, s):
        raise ValueError(f"lse must be [B, H, S] = {(b, h, s)}, got {tuple(lse.shape)}")


def check_banded_bwd_kernel_inputs(q, k, v, o, lse, g, delta) -> None:
    """Raise unless the CUDA kernels take these tensors: q/k/v/o/dO as
    :func:`check_banded_kernel_inputs` requires, lse and D fp32, contiguous
    ``[B, H, S]``.  Reads only metadata (testable on meta tensors)."""
    _check_shapes(q, k, v, o, lse, g)
    check_banded_kernel_inputs(q, k, v)
    check_kernel_tensor("o", o)
    check_kernel_tensor("dO", g)
    for name, t in (("lse", lse), ("D", delta)):
        if t.dtype != torch.float32:
            raise ValueError(f"banded_flash_attention_bwd kernels take an fp32 {name}; got {t.dtype}")
        if tuple(t.shape) != tuple(lse.shape) or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous [B, H, S] tensor; shape {tuple(t.shape)}, "
                             f"strides {t.stride()}")


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


def launch_banded_bwd(q, k, v, g, lse, delta, dq, dk, dv, geo, scale: float) -> None:
    """One launch pair of the banded kernels: dq at the video rows, dk and dv
    of the video queries' part at every row."""
    b, s, h, _ = q.shape
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    strides = [st for t in (q, k, v, g, dq, dk, dv) for st in t.stride()[:3]]
    err = _library().s2v_banded_attention_bwd(
        ptr(q), ptr(k), ptr(v), ptr(g), ptr(lse), ptr(delta), ptr(dq), ptr(dk), ptr(dv),
        b, h, s, geo.global_len, geo.tokens_per_frame, geo.n_frames, geo.span, geo.window,
        *strides, ctypes.c_float(scale), ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream),
    )
    if err != 0:
        raise RuntimeError(f"banded_flash_attention_bwd kernel launch failed: cudaError {err}")
    banded_flash_attention_bwd.launches += 1


def _banded_flash_attention_bwd_cuda(q, k, v, o, lse, g, geo, scale):
    delta = row_delta(o, g)
    check_banded_bwd_kernel_inputs(q, k, v, o, lse, g, delta)
    for t in (k, v, o, lse, g):
        if t.device != q.device:
            raise ValueError("q, k, v, o, lse, dO must be on one device")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    g_len = geo.global_len
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=k.dtype, device=q.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=q.device)
    launch_banded_bwd(q, k, v, g, lse, delta, dq, dk, dv, geo, scale)
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


def check_banded_local_bwd_kernel_inputs(q_vid, k_full, v_full, o_vid, lse_vid, g_vid, delta) -> None:
    """Raise unless B7's CUDA kernels take these tensors: q/o/dO and k/v as
    :func:`check_kernel_inputs` requires, lse and D fp32, contiguous ``[B, H,
    F_loc·tpf]``.  Reads only metadata (testable on meta tensors)."""
    check_kernel_inputs(q_vid, k_full, v_full)
    check_kernel_tensor("o", o_vid)
    check_kernel_tensor("dO", g_vid)
    for name, t in (("lse", lse_vid), ("D", delta)):
        if t.dtype != torch.float32:
            raise ValueError(f"banded_flash_attention_local_bwd kernels take an fp32 {name}; got {t.dtype}")
        if tuple(t.shape) != tuple(lse_vid.shape) or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous [B, H, F_loc·tpf] tensor; shape {tuple(t.shape)}, "
                             f"strides {t.stride()}")


def launch_banded_local_bwd(q_vid, k, v, g_vid, lse_vid, delta, dq, dk, dv, geo, scale: float) -> None:
    """One launch pair of B7: the shard's dq, and its partial dk and dv at
    every row of the full sequence."""
    b, _, h, _ = q_vid.shape
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    strides = [st for t in (q_vid, k, v, g_vid, dq, dk, dv) for st in t.stride()[:3]]
    err = _library().s2v_banded_attention_local_bwd(
        ptr(q_vid), ptr(k), ptr(v), ptr(g_vid), ptr(lse_vid), ptr(delta), ptr(dq), ptr(dk), ptr(dv),
        b, h, geo.global_len, geo.tokens_per_frame, geo.n_frames, geo.span, geo.window, geo.frame_offset,
        geo.local_frames, *strides, ctypes.c_float(scale),
        ctypes.c_void_p(torch.cuda.current_stream(q_vid.device).cuda_stream),
    )
    if err != 0:
        raise RuntimeError(f"banded_flash_attention_local_bwd kernel launch failed: cudaError {err}")
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
    delta = row_delta(o_vid, g_vid)
    check_banded_local_bwd_kernel_inputs(q_vid, k_full, v_full, o_vid, lse_vid, g_vid, delta)
    for t in (k_full, v_full, o_vid, lse_vid, g_vid):
        if t.device != q_vid.device:
            raise ValueError("q, k, v, o, lse, dO must be on one device")
    if scale is None:
        scale = 1.0 / math.sqrt(q_vid.shape[-1])
    dq = torch.empty(q_vid.shape, dtype=q_vid.dtype, device=q_vid.device)
    dk = torch.empty(k_full.shape, dtype=k_full.dtype, device=q_vid.device)
    dv = torch.empty(v_full.shape, dtype=v_full.dtype, device=q_vid.device)
    launch_banded_local_bwd(q_vid, k_full, v_full, g_vid, lse_vid, delta, dq, dk, dv, geo, scale)
    return dq, dk, dv


banded_flash_attention_local_bwd.launches = 0
