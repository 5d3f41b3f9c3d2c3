"""Kernel B1: non-causal flash attention, a CUDA C++ kernel for Hopper.

Replaces ``s2v_tpu/ops/pallas/flash_attention.py::flash_attention`` (the
Pallas kernels ``_flash_kernel`` and ``_flash_kernel_bounded``).  The CUDA
source is ``s2v_torch/csrc/flash_attention.cu``; it is compiled with ``nvcc``
for ``sm_90a`` into ``build/`` on the first CUDA call and bound with
``ctypes``.

Bound on an H100 SXM at the main-path shape (B=2, H=48, S=19,126, d=64):
4·B·H·S²·d = 9.0 TFLOP per call, about 9.1 ms at 989 TFLOP/s bf16, against
about 0.94 GB of q/k/v/o traffic (0.28 ms at 3.35 TB/s): compute-bound.  The
3.5·10¹⁰ exponentials per call are a second ceiling of the same order on the
SFUs, which is why the bounded softmax mode (no running max) is the default.

``flash_attention`` dispatches on the device of its inputs: CPU tensors go to
:func:`flash_attention_reference`, the plain PyTorch version; CUDA tensors
launch the kernel or raise.  ``flash_attention.launches`` counts kernel
launches and ``flash_attention.reruns`` the bounded calls that fell back to
the online kernel.

Bounded mode needs one host sync per call (the ``min log l < -55`` check
that decides the online re-run): 42 per denoise step on the main path.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from s2v_torch.utils import native_build

NEG_INF = -1e30
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
SOFTMAX_MODES = ("online", "bounded", "bounded_exp2")
KERNEL_HEAD_DIM = 64
# below this headroom of fp32 (underflow at ~-87 nats, minus 16 e-folds of
# entries that still matter relatively at 1e-7) the bounded result could have
# lost softmax mass: re-run with the online kernel
BOUNDED_MIN_LOG_L = -55.0
# query rows per chunk of the plain version: 512 x 19,126 keys x B*H=96 in
# fp32 is 3.8 GB of logits, which fits beside the model on an 80 GB card
REFERENCE_CHUNK = 512

SOURCE = native_build.CSRC_DIR / "flash_attention.cu"
_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(native_build.build_one(SOURCE)))
        fn = lib.s2v_flash_attention_fwd
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [vp] * 7 + [i32] * 4 + [i64] * 12 + [ctypes.c_float, i32, vp]
        fn.restype = i32
        _lib = lib
    return _lib


def _check_mode(softmax_mode: str) -> None:
    if softmax_mode not in SOFTMAX_MODES:
        raise ValueError(f"unknown softmax_mode {softmax_mode!r}; expected one of {SOFTMAX_MODES}")


def _check_shapes(q, k, v, key_pad_mask) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be [B, S, H, d]")
    if k.shape != v.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} differ")
    if q.shape[0] != k.shape[0] or q.shape[2:] != k.shape[2:]:
        raise ValueError(f"q {tuple(q.shape)} does not match k {tuple(k.shape)}")
    if key_pad_mask is not None and tuple(key_pad_mask.shape) != (k.shape[1],):
        raise ValueError(f"key_pad_mask must be [Skv={k.shape[1]}], got {tuple(key_pad_mask.shape)}")


def check_kernel_tensor(name: str, t: torch.Tensor) -> None:
    """Raise unless the kernels take ``t`` as a ``[B, S, H, d]`` operand:
    bf16, d = 64, rows contiguous and 16-byte aligned (base pointer and
    strides: rows are loaded with 16-byte ``cp.async``)."""
    if t.dtype != torch.bfloat16:
        raise ValueError(f"flash_attention kernels take bf16; {name} is {t.dtype}")
    if t.shape[-1] != KERNEL_HEAD_DIM:
        raise ValueError(f"flash_attention kernels take d={KERNEL_HEAD_DIM}; {name} has d={t.shape[-1]}")
    if t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:-1]):
        raise ValueError(f"{name} needs a contiguous last dim and 16-byte aligned rows; strides {t.stride()}")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must start on a 16-byte boundary; its storage offset is {t.storage_offset()}")


def check_kernel_inputs(q, k, v, key_pad_mask=None) -> None:
    """Raise unless the CUDA kernel takes these tensors (see
    :func:`check_kernel_tensor`).  Reads only metadata, so it is checked
    before any launch (and testable on CPU or meta tensors).  The mask is
    read byte by byte and needs no alignment."""
    _check_shapes(q, k, v, key_pad_mask)
    for name, t in (("q", q), ("k", k), ("v", v)):
        check_kernel_tensor(name, t)
    if q.shape[0] * q.shape[2] > 65535:
        raise ValueError("B * H must be at most 65535 (grid y)")


def _bound_m0(q, k, scale: float) -> torch.Tensor:
    """Per-call logit bound M0 = max‖scale·q‖ · max‖k‖ (Cauchy-Schwarz), in
    fp32, rounded to k's dtype: the lse add-back must be the exact value the
    kernel applied (s2v_tpu flash_attention.py:364-367)."""
    qmax = q.float().square().sum(-1).amax().sqrt() * scale
    kmax = k.float().square().sum(-1).amax().sqrt()
    return (qmax * kmax).to(k.dtype).float()


def flash_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: Optional[float] = None,
    return_lse: bool = False,
    key_pad_mask: Optional[torch.Tensor] = None,
    softmax_mode: str = "online",
):
    """The plain PyTorch version of the kernel, same signature and contract.

    q ``[B, Sq, H, d]``, k/v ``[B, Skv, H, d]`` -> o ``[B, Sq, H, d]`` in q's
    dtype (and lse ``[B, H, Sq]`` fp32).  fp32 softmax, chunked over queries.
    ``key_pad_mask`` ``[Skv]``: True on keys to exclude.  The three modes
    follow the TPU kernel's: bounded offsets the logits by M0 (rounded to
    k's dtype) and re-runs the online version when min log l < -55;
    bounded_exp2 does the same in log2 units.  Logits are scaled in fp32
    after the product, as the CUDA kernel does (the TPU kernel scales q in
    q's dtype first; for fp32 inputs the two differ only by rounding)."""
    _check_mode(softmax_mode)
    _check_shapes(q, k, v, key_pad_mask)
    d = q.shape[-1]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    use_exp2 = softmax_mode == "bounded_exp2"
    c = scale * (LOG2E if use_exp2 else 1.0)
    kf = k.float().permute(0, 2, 3, 1)  # [B, H, d, Skv]
    vf = v.float().transpose(1, 2)  # [B, H, Skv, d]
    valid = None
    if key_pad_mask is not None:
        valid = ~key_pad_mask.to(device=q.device, dtype=torch.bool)
    bounded = softmax_mode != "online"
    m0 = _bound_m0(q, k, c) if bounded else None

    outs, lses = [], []
    for c0 in range(0, q.shape[1], REFERENCE_CHUNK):
        qc = q[:, c0:c0 + REFERENCE_CHUNK].float().transpose(1, 2)  # [B, H, chunk, d]
        s = torch.matmul(qc, kf) * c  # [B, H, chunk, Skv] fp32
        if bounded:
            s = s - m0
            p = torch.exp2(s) if use_exp2 else torch.exp(s)
            if valid is not None:
                p = p * valid
            l = p.sum(-1, keepdim=True)
            o = torch.matmul(p, vf) / torch.where(l == 0, torch.ones_like(l), l)
            logl = torch.where(l == 0, torch.full_like(l, NEG_INF), torch.log(l))
            lses.append(logl[..., 0])
        else:
            if valid is not None:
                s = s.masked_fill(~valid, float("-inf"))
            m = s.amax(-1, keepdim=True).clamp_min(NEG_INF)
            p = torch.exp(s - m)
            l = p.sum(-1, keepdim=True)
            o = torch.matmul(p, vf) / torch.where(l == 0, torch.ones_like(l), l)
            lse = torch.where(l == 0, torch.full_like(l, NEG_INF), m + torch.log(l))
            lses.append(lse[..., 0])
        outs.append(o.transpose(1, 2).to(q.dtype))
    o = torch.cat(outs, dim=1)
    lse = torch.cat(lses, dim=-1)  # [B, H, Sq]
    if bounded:
        if float(lse.amin()) < BOUNDED_MIN_LOG_L:
            return flash_attention_reference(q, k, v, scale, return_lse, key_pad_mask, "online")
        lse = lse + (m0 * LN2 if use_exp2 else m0)
    return (o, lse) if return_lse else o


def _launch(q, k, v, o, lse, mask, m0_log2, scale_log2: float, bounded: bool) -> None:
    b, sq, h, _ = q.shape
    skv = k.shape[1]
    ptr = lambda t: ctypes.c_void_p(t.data_ptr() if t is not None else 0)  # noqa: E731
    strides = [s for t in (q, k, v, o) for s in t.stride()[:3]]
    err = _library().s2v_flash_attention_fwd(
        ptr(q), ptr(k), ptr(v), ptr(o), ptr(lse), ptr(mask), ptr(m0_log2),
        b, h, sq, skv, *strides, ctypes.c_float(scale_log2), int(bounded),
        ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream),
    )
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: cudaError {err}")
    flash_attention.launches += 1


def _flash_attention_cuda(q, k, v, scale, return_lse, key_pad_mask, softmax_mode):
    check_kernel_inputs(q, k, v, key_pad_mask)
    for t in (k, v):
        if t.device != q.device:
            raise ValueError("q, k, v must be on one device")
    b, sq, h, d = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    mask = None
    if key_pad_mask is not None:
        mask = key_pad_mask.to(device=q.device, dtype=torch.uint8).contiguous()
    o = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    scale_log2 = scale * LOG2E

    def online(want_lse):
        lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device) if want_lse else None
        _launch(q, k, v, o, lse, mask, None, scale_log2, bounded=False)
        return lse

    if softmax_mode == "online":
        lse = online(return_lse)
        return (o, lse) if return_lse else o

    use_exp2 = softmax_mode == "bounded_exp2"
    m0 = _bound_m0(q, k, scale * (LOG2E if use_exp2 else 1.0))  # device scalar
    m0_log2 = (m0 if use_exp2 else m0 * LOG2E).reshape(1).contiguous()
    logl = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    _launch(q, k, v, o, logl, mask, m0_log2, scale_log2, bounded=True)
    # the one host sync of the call: the underflow guard
    if float(logl.amin()) < BOUNDED_MIN_LOG_L:
        flash_attention.reruns += 1
        lse = online(return_lse)
        return (o, lse) if return_lse else o
    if return_lse:
        return o, logl + (m0 * LN2 if use_exp2 else m0)
    return o


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: Optional[float] = None,
    return_lse: bool = False,
    key_pad_mask: Optional[torch.Tensor] = None,
    softmax_mode: str = "online",
):
    """softmax(scale·q·kᵀ)·v, non-causal.  q ``[B, Sq, H, d]``, k/v
    ``[B, Skv, H, d]``; returns ``[B, Sq, H, d]`` in q's dtype, plus the fp32
    lse ``[B, H, Sq]`` when ``return_lse``.  ``softmax_mode`` is ``online``,
    ``bounded`` or ``bounded_exp2`` (see the module docstring).

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise (bf16 and d = 64 only)."""
    _check_mode(softmax_mode)
    devices = {t.device.type for t in (q, k, v)}
    if devices == {"cpu"}:
        return flash_attention_reference(q, k, v, scale, return_lse, key_pad_mask, softmax_mode)
    if devices == {"cuda"}:
        return _flash_attention_cuda(q, k, v, scale, return_lse, key_pad_mask, softmax_mode)
    raise ValueError(f"flash_attention needs q, k, v all on the CPU or all on CUDA, got {devices}")


flash_attention.launches = 0
flash_attention.reruns = 0
