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
the video queries through one launch of ``s2v_torch/csrc/banded_attention.cu``,
compiled with ``nvcc`` for ``sm_90a`` into ``build/`` on the first CUDA call
and bound with ``ctypes``.  CPU tensors take
:func:`banded_flash_attention_reference`, the plain PyTorch version.
``banded_flash_attention.launches`` counts launches of the banded kernel.

Bound on an H100 SXM at the main-path shape (B=2, H=48, G=1,576, tpf=1,350,
F=13, w=2, d=64): the banded launch does 4·B·H·d·(17,550 × 8,326) = 3.59·10¹²
operations (3.63 ms at 989 TFLOP/s bf16), the global queries' B1 call
4·B·H·d·(1,576 × 19,126) = 7.4·10¹¹ (0.75 ms); both compute-bound.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional, Tuple

import torch

from s2v_torch.kernels.flash_attention import (
    LOG2E,
    REFERENCE_CHUNK,
    check_kernel_inputs,
    flash_attention,
)
from s2v_torch.utils import native_build

SOURCE = native_build.CSRC_DIR / "banded_attention.cu"
_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(native_build.build_one(SOURCE)))
        fn = lib.s2v_banded_attention_fwd
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [vp] * 5 + [i32] * 8 + [i64] * 12 + [ctypes.c_float, vp]
        fn.restype = i32
        _lib = lib
    return _lib


class BandGeometry(NamedTuple):
    """Static geometry of a windowed call, from host ints."""

    global_len: int  # G: the text | ref tokens, attended by and attending everything
    tokens_per_frame: int
    n_frames: int  # F
    window: int  # w: the half-width in frames
    span: int  # min(2w + 1, F): frames each video query attends

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

    def pairs(self) -> Tuple[int, int]:
        """(query, key) pairs the function computes: (video queries' band,
        global queries' full rows)."""
        vid = self.n_frames * self.tokens_per_frame
        return vid * (self.global_len + self.span * self.tokens_per_frame), self.global_len * (self.global_len + vid)


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
                        min(2 * window_frames + 1, n_frames))


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
    shape, and what B1's kernel requires (bf16, d = 64, 16-byte aligned
    rows, B·H ≤ 65535).  Reads only metadata (testable on meta tensors)."""
    _check_qkv(q, k, v)
    check_kernel_inputs(q, k, v)


def launch_banded(q, k, v, o, lse, geo: BandGeometry, scale: float) -> None:
    """One launch of the banded kernel: the video rows of ``o`` (and of
    ``lse``, a contiguous ``[B, H, S]`` fp32 tensor, or None)."""
    b, s, h, _ = q.shape
    ptr = lambda t: ctypes.c_void_p(t.data_ptr() if t is not None else 0)  # noqa: E731
    strides = [st for t in (q, k, v, o) for st in t.stride()[:3]]
    err = _library().s2v_banded_attention_fwd(
        ptr(q), ptr(k), ptr(v), ptr(o), ptr(lse), b, h, s, geo.global_len, geo.tokens_per_frame,
        geo.n_frames, geo.span, geo.window, *strides, ctypes.c_float(scale * LOG2E),
        ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream),
    )
    if err != 0:
        raise RuntimeError(f"banded_flash_attention kernel launch failed: cudaError {err}")
    banded_flash_attention.launches += 1


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
    raise (bf16 and d = 64 only)."""
    _check_qkv(q, k, v)
    geo = band_geometry(q.shape[1], global_len, tokens_per_frame, window_frames)
    devices = {t.device.type for t in (q, k, v)}
    if devices == {"cpu"}:
        return banded_flash_attention_reference(q, k, v, global_len, tokens_per_frame, window_frames, scale,
                                                return_lse)
    if devices == {"cuda"}:
        return _banded_flash_attention_cuda(q, k, v, geo, scale, return_lse)
    raise ValueError(f"banded_flash_attention needs q, k, v all on the CPU or all on CUDA, got {devices}")


banded_flash_attention.launches = 0
