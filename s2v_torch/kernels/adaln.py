"""The adaLN-Zero LayerNorms, modulation and stream join of the DiT in one
CUDA kernel.

Replaces no TPU kernel: the JAX package leaves this chain to XLA, which
fuses it.  In PyTorch the chain (``ops/norms.py::layer_norm`` on each of
the text, ref and video streams, the multiply by ``1 + scale`` and the add
of ``shift``, then ``torch.cat`` into the joint ``[text | ref | video]``
sequence) runs as some ten elementwise and reduction passes over every
value.  The CUDA source is ``s2v_torch/csrc/adaln.cu``, compiled with
``nvcc`` for ``sm_90a`` into ``build/`` on the first CUDA call and bound
with ``ctypes``.

Bound on an H100 SXM: memory.  One read of the streams and one write of
the joined rows: 0.470 GB a call at the 5b shape (B=2, 19,126 tokens,
D=3,072, bf16; 0.140 ms at 3.35 TB/s), 0.294 GB at the 2b shape (D=1,920,
fp16; 0.088 ms), 1.209 GB at the 1.5 shape (49,186 tokens; 0.361 ms).

:func:`adaln_zero_join` takes the kernel when it can: CUDA streams of bf16
or fp16 with D a multiple of 8 and at most :data:`MAX_DIM`, and no gradient
needed (grad mode off, or none of the streams, the shift and scale rows and
the norm params requiring one); the kernel has no backward, so the trainers
and remat's recompute keep the plain chain.  Every other call, on the CPU,
in fp32 or under autograd, runs :func:`adaln_zero_join_reference`, the
plain chain itself.  ``native.count`` records each launch as
``adaln_zero_join`` (by element type) and each call that ran the plain
chain as ``adaln_zero_join_plain``.

Precision: the kernel computes in fp32 throughout (the mean, the variance
of the centred values, the norm's apply and the modulation) and rounds
once to the storage dtype (see :func:`adaln_zero_join_emulated`); the plain
chain rounds after each bf16/fp16 op of the apply and of the modulation, so
the kernel's result is the same or finer.  The two agree within the repo's
bf16/fp16 limits (2^-6 of the largest value, 1e-2 relative L2).
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from s2v_torch.kernels import native
from s2v_torch.ops.norms import layer_norm
from s2v_torch.utils import native_build
from s2v_torch.utils.device import needs_grad

MAX_DIM = 4096  # 16 vectors of 8 channels a lane of a 32-lane row
STREAMS = 3  # text, ref, video
SOURCE = native_build.CSRC_DIR / "adaln.cu"
# the C entry point of each element type
ENTRY = {torch.bfloat16: "s2v_adaln_zero", torch.float16: "s2v_adaln_zero_f16"}

Modulation = Tuple[torch.Tensor, torch.Tensor]  # (shift, scale), each [B, D] fp32


class _Args(ctypes.Structure):
    """``csrc/adaln.cu``'s ``S2vAdalnArgs``, field for field."""

    _fields_ = [
        ("src", ctypes.c_void_p * STREAMS),
        ("shift", ctypes.c_void_p * STREAMS),
        ("scale", ctypes.c_void_p * STREAMS),
        ("sb", ctypes.c_longlong * STREAMS),
        ("ss", ctypes.c_longlong * STREAMS),
        ("mb_shift", ctypes.c_longlong * STREAMS),
        ("mb_scale", ctypes.c_longlong * STREAMS),
        ("len", ctypes.c_int * STREAMS),
        ("dst", ctypes.c_void_p),
        ("weight", ctypes.c_void_p),
        ("bias", ctypes.c_void_p),
        ("batch", ctypes.c_int),
        ("dim", ctypes.c_int),
        ("eps", ctypes.c_float),
    ]


LIB = native_build.Library(SOURCE, {name: [ctypes.POINTER(_Args), native.STREAM] for name in ENTRY.values()})


def modulate_reference(x: torch.Tensor, norm: dict, shift: torch.Tensor, scale: torch.Tensor,
                       eps: float) -> torch.Tensor:
    """One stream's plain chain: ``layer_norm`` over D with the norm's
    ``weight`` and ``bias``, then ``* (1 + scale) + shift`` with the
    ``[B, D]`` fp32 rows rounded to x's dtype."""
    xn = layer_norm(x, norm["weight"], norm["bias"], eps)
    dt = x.dtype
    return xn * (1.0 + scale[:, None, :]).to(dt) + shift[:, None, :].to(dt)


def adaln_zero_join_reference(streams: Sequence[torch.Tensor], mods: Sequence[Modulation], norm: dict,
                              eps: float) -> torch.Tensor:
    """The plain chain: :func:`modulate_reference` of each stream, joined
    along the tokens in the order given (one stream is returned as it
    comes)."""
    outs = [modulate_reference(x, norm, shift, scale, eps) for x, (shift, scale) in zip(streams, mods)]
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


def adaln_zero_join_emulated(streams: Sequence[torch.Tensor], mods: Sequence[Modulation], norm: dict,
                             eps: float) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch ops: fp32 statistics, apply and
    modulation, one rounding to the storage dtype at the end (the kernel's
    sums run in another order, and it fuses multiply-adds).  The norm
    params are taken in the storage dtype, as the plain chain takes them."""

    def one(x, shift, scale):
        xf = x.float()
        centred = xf - xf.mean(-1, keepdim=True)
        rstd = torch.reciprocal(torch.sqrt(centred.square().mean(-1, keepdim=True) + eps))
        y = centred * rstd * norm["weight"].to(x.dtype).float() + norm["bias"].to(x.dtype).float()
        return (y * (1.0 + scale.float()[:, None, :]) + shift.float()[:, None, :]).to(x.dtype)

    return torch.cat([one(x, shift, scale) for x, (shift, scale) in zip(streams, mods)], dim=1)


def ulps_from_emulation(got: torch.Tensor, emulated: torch.Tensor) -> float:
    """The largest distance of the kernel's values from the emulation's, in
    units in the last place of the storage type: each taken at the emulated
    value or, where that is below eps times the largest, at eps times the
    largest.  There the modulation's last fp32 add cancels, and its
    rounding, relative to its terms, can pass a smaller value's ulp (the
    kernel fuses multiply-adds that the emulation rounds apart)."""
    e = emulated.float()
    eps = torch.finfo(emulated.dtype).eps
    floor = max(eps * e.abs().max().item(), torch.finfo(emulated.dtype).tiny)
    ulp = eps * torch.exp2(torch.floor(torch.log2(e.abs().clamp_min(floor))))
    return ((got.float() - e).abs() / ulp).max().item()


def check_kernel_inputs(streams: Sequence[torch.Tensor], mods: Sequence[Modulation], norm: dict) -> None:
    """Raise unless the kernel takes these tensors: one to three streams
    ``[B, L_k, D]`` of one batch, width and dtype (bf16 or fp16), D a
    multiple of 8 and at most :data:`MAX_DIM`, rows contiguous and 16-byte
    aligned (base pointer and strides: the kernel loads 16 bytes a thread);
    a (shift, scale) pair of ``[B, D]`` fp32 rows a stream, each 16-byte
    aligned; the norm params ``[D]`` contiguous in the streams' dtype.
    Reads only metadata, so it is checked before any launch (and testable
    on the CPU)."""
    if not 1 <= len(streams) <= STREAMS or len(mods) != len(streams):
        raise ValueError(f"the adaln kernel takes 1 to {STREAMS} streams, each with a (shift, scale); got "
                         f"{len(streams)} streams and {len(mods)} modulations")
    first = streams[0]
    if first.dtype not in ENTRY:
        raise ValueError(f"the adaln kernel takes bfloat16 or float16; the streams are {first.dtype}")
    b, d = first.shape[0], first.shape[-1]
    if d % 8 or not 0 < d <= MAX_DIM:
        raise ValueError(f"the adaln kernel takes a width D that is a multiple of 8 up to {MAX_DIM}; got {d}")
    for i, x in enumerate(streams):
        if x.dim() != 3 or x.shape[0] != b or x.shape[2] != d or x.dtype != first.dtype:
            raise ValueError(f"stream {i} is {tuple(x.shape)} {x.dtype}; the first is {tuple(first.shape)} "
                             f"{first.dtype}: every stream [B, L, D] of one B, D and dtype")
        if x.stride(-1) != 1 or any((s * x.element_size()) % 16 for s in x.stride()[:2]) or x.data_ptr() % 16:
            raise ValueError(f"stream {i} needs contiguous rows, 16-byte aligned (strides {x.stride()}, "
                             f"storage offset {x.storage_offset()})")
    for i, pair in enumerate(mods):
        for name, t in zip(("shift", "scale"), pair):
            if t.dtype != torch.float32 or tuple(t.shape) != (b, d):
                raise ValueError(f"stream {i}'s {name} must be [{b}, {d}] float32, got {tuple(t.shape)} {t.dtype}")
            if t.stride(-1) != 1 or (t.stride(0) * 4) % 16 or t.data_ptr() % 16:
                raise ValueError(f"stream {i}'s {name} needs contiguous, 16-byte aligned rows "
                                 f"(strides {t.stride()}, storage offset {t.storage_offset()})")
    for key in ("weight", "bias"):
        t = norm[key]
        if tuple(t.shape) != (d,) or t.dtype != first.dtype or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"norm['{key}'] must be [{d}] contiguous {first.dtype}, got {tuple(t.shape)} {t.dtype}")


def _kernel_engages(streams: Sequence[torch.Tensor], mods: Sequence[Modulation], norm: dict) -> bool:
    """Whether a call takes the kernel: CUDA, bf16 or fp16, D a multiple of
    8 up to :data:`MAX_DIM`, and no gradient needed (the kernel has no
    backward)."""
    x = streams[0]
    if not (all(s.is_cuda for s in streams) and x.dtype in ENTRY and x.shape[-1] % 8 == 0
            and x.shape[-1] <= MAX_DIM):
        return False
    return not needs_grad(*streams, *(t for pair in mods for t in pair), norm["weight"], norm["bias"])


def _launch(streams, mods, norm, eps):
    x = streams[0]
    if any(t.device != x.device for t in (*streams, *(t for pair in mods for t in pair))):
        raise ValueError("the streams and their modulation must be on one device")
    # the params in the streams' dtype, as the plain chain applies them (a no-op for the model's own)
    norm = {key: norm[key].to(device=x.device, dtype=x.dtype).contiguous() for key in ("weight", "bias")}
    check_kernel_inputs(streams, mods, norm)
    b, d = x.shape[0], x.shape[-1]
    out = torch.empty((b, sum(s.shape[1] for s in streams), d), dtype=x.dtype, device=x.device)
    args = _Args(batch=b, dim=d, eps=eps, dst=out.data_ptr(), weight=norm["weight"].data_ptr(),
                 bias=norm["bias"].data_ptr())
    for k, (s, (shift, scale)) in enumerate(zip(streams, mods)):
        args.src[k], args.shift[k], args.scale[k] = s.data_ptr(), shift.data_ptr(), scale.data_ptr()
        args.sb[k], args.ss[k] = s.stride(0), s.stride(1)
        args.mb_shift[k], args.mb_scale[k] = shift.stride(0), scale.stride(0)
        args.len[k] = s.shape[1]
    native.launch(LIB, ENTRY[x.dtype], x.device, ctypes.byref(args))
    native.count("adaln_zero_join", x.dtype)
    return out


def adaln_zero_join(streams: Sequence[torch.Tensor], mods: Sequence[Modulation], norm: dict,
                    eps: float) -> torch.Tensor:
    """Streams ``[B, L_k, D]`` (up to three, in the order they are joined),
    each LayerNormed over D with ``norm`` (``{"weight", "bias"}``) and
    ``eps`` and modulated by its ``(shift, scale)`` ``[B, D]`` fp32 rows,
    joined along the tokens into ``[B, sum L_k, D]`` in the streams' dtype.
    See the module docstring for which calls take the kernel."""
    if _kernel_engages(streams, mods, norm):
        return _launch(streams, mods, norm, eps)
    native.count("adaln_zero_join_plain")
    return adaln_zero_join_reference(streams, mods, norm, eps)
