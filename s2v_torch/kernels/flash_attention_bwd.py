"""Kernel B2: the backward of non-causal flash attention, a CUDA C++ kernel
for Hopper.

Replaces ``s2v_tpu/ops/pallas/flash_attention_bwd.py::flash_attention_bwd``
(the Pallas kernels ``_dq_kernel`` and ``_dkv_kernel``).  The CUDA source is
``s2v_torch/csrc/flash_attention_bwd.cu``: two deterministic kernels (dq per
query tile; dk and dv per key tile), compiled with ``nvcc`` for ``sm_90a``
into ``build/`` on the first CUDA call and bound with ``ctypes``.

Given the forward's q, k, v, o, its log-sum-exp ``lse`` (natural log,
``[B, H, Sq]``) and dO, with ``D = rowsum(dO ∘ o)`` (computed here, in fp32):

    P  = exp(scale·q·kᵀ − lse)     dV = Pᵀ·dO
    dS = P ∘ (dO·vᵀ − D)           dQ = scale·dS·k     dK = scale·dSᵀ·q

Bound on an H100 SXM at the training shape (B=1, S=19,126, H=48, d=64): the
five products are 10·B·H·S²·d = 1.12·10¹³ operations, 11.4 ms at 989 TFLOP/s
bf16, against ~0.95 GB of traffic (0.28 ms at 3.35 TB/s): compute-bound.
The two-kernel design computes q·kᵀ and dO·vᵀ twice (7 products).

``flash_attention_bwd`` dispatches on the device of its inputs: CPU tensors
go to :func:`flash_attention_bwd_reference`, the plain PyTorch version; CUDA
tensors launch the kernel or raise.  ``flash_attention_bwd.launches`` counts
calls that launched the kernel pair.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from s2v_torch.kernels.flash_attention import REFERENCE_CHUNK, check_kernel_inputs, check_kernel_tensor
from s2v_torch.utils import native_build

SOURCE = native_build.CSRC_DIR / "flash_attention_bwd.cu"
_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(native_build.build_one(SOURCE)))
        fn = lib.s2v_flash_attention_bwd
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [vp] * 9 + [i32] * 4 + [i64] * 21 + [ctypes.c_float, vp]
        fn.restype = i32
        _lib = lib
    return _lib


def _check_shapes(q, k, v, o, lse, g) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be [B, S, H, d]")
    if k.shape != v.shape or q.shape[0] != k.shape[0] or q.shape[2:] != k.shape[2:]:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} do not match")
    for name, t in (("o", o), ("dO", g)):
        if t.shape != q.shape:
            raise ValueError(f"{name} {tuple(t.shape)} must have q's shape {tuple(q.shape)}")
    b, sq, h, _ = q.shape
    if tuple(lse.shape) != (b, h, sq):
        raise ValueError(f"lse must be [B, H, Sq] = {(b, h, sq)}, got {tuple(lse.shape)}")


def row_delta(o: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """D = rowsum(dO ∘ o) in fp32, ``[B, H, Sq]`` contiguous."""
    return (g.float() * o.float()).sum(-1).transpose(1, 2).contiguous()


def check_bwd_kernel_inputs(q, k, v, o, lse, g, delta) -> None:
    """Raise unless the CUDA kernel takes these tensors: q/k/v/o/dO as
    :func:`check_kernel_inputs` requires, lse and D fp32, contiguous
    ``[B, H, Sq]``.  Reads only metadata (testable on meta tensors)."""
    _check_shapes(q, k, v, o, lse, g)
    check_kernel_inputs(q, k, v)
    check_kernel_tensor("o", o)
    check_kernel_tensor("dO", g)
    for name, t in (("lse", lse), ("D", delta)):
        if t.dtype != torch.float32:
            raise ValueError(f"flash_attention_bwd kernel takes an fp32 {name}; got {t.dtype}")
        if tuple(t.shape) != tuple(lse.shape) or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous [B, H, Sq] tensor; shape {tuple(t.shape)}, "
                             f"strides {t.stride()}")


def flash_attention_bwd_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    lse: torch.Tensor,
    g: torch.Tensor,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of the kernel, same signature and contract:
    fp32 math chunked over queries (``REFERENCE_CHUNK`` rows at a time), P
    recomputed from ``lse``.  Logits and dq/dk are scaled in fp32 after the
    products, as the kernel does (the TPU kernel scales q in q's dtype
    first; for fp32 inputs the two differ only by rounding).  Returns dq,
    dk, dv in q's, k's and v's dtypes."""
    _check_shapes(q, k, v, o, lse, g)
    return masked_bwd_reference(q, k, v, o, lse, g, scale)


def masked_bwd_reference(q, k, v, o, lse, g, scale=None, mask_rows=None):
    """The chunked fp32 backward of :func:`flash_attention_bwd_reference`,
    with ``mask_rows(rows)`` -> ``[len(rows), Skv]`` bool (True where the
    query attends the key) setting P to 0 outside the mask, or no mask."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    kf = k.float().transpose(1, 2)  # [B, H, Skv, d]
    vf = v.float().transpose(1, 2)
    delta = row_delta(o, g)  # [B, H, Sq]
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    dqs = []
    for c0 in range(0, q.shape[1], REFERENCE_CHUNK):
        c1 = c0 + REFERENCE_CHUNK
        qc = q[:, c0:c1].float().transpose(1, 2)  # [B, H, chunk, d]
        gc = g[:, c0:c1].float().transpose(1, 2)
        logits = torch.matmul(qc, kf.transpose(-1, -2)) * scale
        if mask_rows is not None:
            # -inf, not a product with the mask: the lse bounds only the
            # attended logits, so a masked one may overflow exp
            logits = logits.masked_fill(~mask_rows(torch.arange(c0, c0 + qc.shape[2], device=q.device)),
                                        float("-inf"))
        p = torch.exp(logits - lse[:, :, c0:c1, None].float())
        dv += torch.matmul(p.transpose(-1, -2), gc)
        ds = p * (torch.matmul(gc, vf.transpose(-1, -2)) - delta[:, :, c0:c1, None])
        dqs.append((torch.matmul(ds, kf) * scale).transpose(1, 2))
        dk += torch.matmul(ds.transpose(-1, -2), qc)
    dq = torch.cat(dqs, dim=1)
    return (dq.to(q.dtype), (dk * scale).transpose(1, 2).to(k.dtype), dv.transpose(1, 2).to(v.dtype))


def _launch(q, k, v, g, lse, delta, dq, dk, dv, scale: float) -> None:
    b, sq, h, _ = q.shape
    skv = k.shape[1]
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    strides = [s for t in (q, k, v, g, dq, dk, dv) for s in t.stride()[:3]]
    err = _library().s2v_flash_attention_bwd(
        ptr(q), ptr(k), ptr(v), ptr(g), ptr(lse), ptr(delta), ptr(dq), ptr(dk), ptr(dv),
        b, h, sq, skv, *strides, ctypes.c_float(scale),
        ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream),
    )
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd kernel launch failed: cudaError {err}")
    flash_attention_bwd.launches += 1


def _flash_attention_bwd_cuda(q, k, v, o, lse, g, scale):
    delta = row_delta(o, g)
    check_bwd_kernel_inputs(q, k, v, o, lse, g, delta)
    for t in (k, v, o, lse, g):
        if t.device != q.device:
            raise ValueError("q, k, v, o, lse, dO must be on one device")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=k.dtype, device=q.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=q.device)
    _launch(q, k, v, g, lse, delta, dq, dk, dv, scale)
    return dq, dk, dv


def flash_attention_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    lse: torch.Tensor,
    g: torch.Tensor,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of ``o = softmax(scale·q·kᵀ)·v``.  q, o, g (= dL/do)
    ``[B, Sq, H, d]``, k/v ``[B, Skv, H, d]`` (Skv may differ from Sq), lse
    ``[B, H, Sq]`` fp32 (the forward's, natural log).

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise (bf16 and d = 64 only)."""
    devices = {t.device.type for t in (q, k, v, o, lse, g)}
    if devices == {"cpu"}:
        return flash_attention_bwd_reference(q, k, v, o, lse, g, scale)
    if devices == {"cuda"}:
        return _flash_attention_bwd_cuda(q, k, v, o, lse, g, scale)
    raise ValueError(f"flash_attention_bwd needs all its inputs on the CPU or all on CUDA, got {devices}")


flash_attention_bwd.launches = 0
