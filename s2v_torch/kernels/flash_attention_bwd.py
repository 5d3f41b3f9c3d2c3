"""Kernel B2: the backward of non-causal flash attention, CUDA C++ kernels
for Hopper.

Replaces ``s2v_tpu/ops/pallas/flash_attention_bwd.py::flash_attention_bwd``
(the Pallas kernels ``_dq_kernel`` and ``_dkv_kernel``).  The CUDA source is
``s2v_torch/csrc/flash_attention_bwd.cu`` (with the shared Hopper layer
``csrc/hopper.cuh``), compiled with ``nvcc`` for ``sm_90a`` into ``build/``
on the first CUDA call and bound with ``ctypes``.

Given the forward's q, k, v, o, its log-sum-exp ``lse`` (natural log,
``[B, H, Sq]``) and dO, with ``D = rowsum(dO ∘ o)`` in fp32:

    P  = exp(scale·q·kᵀ − lse)     dV = Pᵀ·dO
    dS = P ∘ (dO·vᵀ − D)           dQ = scale·dS·k     dK = scale·dSᵀ·q

Bound on an H100 SXM at the training shape (B=1, S=19,126, H=48, d=64): the
five products are 10·B·H·S²·d = 1.12·10¹³ operations, 11.4 ms at 989 TFLOP/s
bf16, against ~0.95 GB of traffic (0.28 ms at 3.35 TB/s): compute-bound.

Element types: bf16 and fp16 (the 2b family), one set of kernels templated
on the type, two C entry points; P and dS are rounded to the input type
before their products.  fp32 inputs launch the fp32 kernels of
``csrc/attention_f32_bwd.cu`` (``kernels/attention_f32.py``: 3xTF32
products, P and dS kept in fp32).  fp16 has no normal values below
2⁻¹⁴, and dS takes dO's scale, which a training step with no loss scaler
puts near 10⁻⁶: in fp16 the kernels scale dS by 2^e before its rounding
and dq, dk by 2^-e after (:func:`ds_exponent`), so dq and dk keep their
entries where the JAX package's fp32 dS keeps them.

One call launches three kernels on the current stream: a pre-pass (D and
lse·log2 e into a padded fp32 workspace the wrapper allocates), a dq kernel
(one block per 128 queries, K/V streamed) and a dk/dv kernel (one block per
128 keys, q/dO streamed), both warp-specialised with TMA, mbarriers and
``wgmma``.  Every output is written by one block, so results are the same
bit for bit on every run; q·kᵀ and dO·vᵀ are computed in both kernels (7
products for the bound's 5).  :func:`flash_attention_bwd_blocked` emulates
that schedule on any device (tile order, bf16 rounding of P and dS, fp32
sums in tile order).

``flash_attention_bwd`` dispatches on the device of its inputs: CPU tensors
go to :func:`flash_attention_bwd_reference`, the plain PyTorch version; CUDA
tensors launch the kernels or raise.  ``native.count`` records each call
that launched them as ``flash_attention_bwd`` (by element type).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from s2v_torch.kernels import attention_f32, native
from s2v_torch.kernels.flash_attention import (
    LOG2E,
    REFERENCE_CHUNK,
    check_kernel_inputs,
    check_kernel_tensor,
)
from s2v_torch.kernels.native import F32, I32, I64, PTR, STREAM, ptr
from s2v_torch.utils import native_build

SOURCE = native_build.CSRC_DIR / "flash_attention_bwd.cu"
# the C entry point of each element type
ENTRY = {torch.bfloat16: "s2v_flash_attention_bwd", torch.float16: "s2v_flash_attention_bwd_f16"}
# rows of each tile the kernels stream (keys in the dq kernel, queries in
# the dk/dv kernel); a block owns 128 resident rows
KERNEL_TILE_ROWS = 64
# fp16: the scaled dS stays under this power of two (fp16 tops out at 65,504)
DS_BOUND_LOG2 = 14
# the parts of one call, a bit mask of the C entry point
PART_PREPASS, PART_DQ, PART_DKV = 1, 2, 4
ALL_PARTS = PART_PREPASS | PART_DQ | PART_DKV
LIB = native_build.Library(SOURCE, {**{name: [PTR] * 12 + [I32] * 4 + [I64] * 24 + [F32, I32, STREAM]
                                 for name in ENTRY.values()},
                              "s2v_flash_attention_bwd_smem_bytes": []})


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


def ds_exponent(v: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The fp16 kernels' dS exponent e, an int32 device scalar ``[1]``: dS is
    multiplied by 2^e before its fp16 rounding and dq, dk by 2^-e after
    (exact: powers of two).  |dS_ij| = P_ij·|dO_i·v_j − dO_i·o_i| is at most
    2·max‖dO_i‖·max‖v_j‖ (P ≤ 1, o a convex combination of v's rows); e is
    the largest that keeps this bound under 2^DS_BOUND_LOG2."""
    norm = lambda x: torch.linalg.vector_norm(x, dim=-1, dtype=torch.float32).amax()  # noqa: E731
    _, exp = torch.frexp(2 * norm(g) * norm(v))  # bound = m·2^exp, m in [0.5, 1)
    return (DS_BOUND_LOG2 - exp).clamp(-100, 100).to(torch.int32).reshape(1)


def row_delta(o: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """D = rowsum(dO ∘ o) in fp32, ``[B, H, Sq]`` contiguous."""
    return (g.float() * o.float()).sum(-1).transpose(1, 2).contiguous()


def check_bwd_kernel_inputs(q, k, v, o, lse, g) -> None:
    """Raise unless the CUDA kernels take these tensors: q/k/v/o/dO as
    :func:`check_kernel_inputs` requires (bf16, fp16 or fp32, all of one type), lse
    fp32, contiguous ``[B, H, Sq]`` (the kernels compute D themselves).
    Reads only metadata (testable on meta tensors)."""
    _check_shapes(q, k, v, o, lse, g)
    check_kernel_inputs(q, k, v)
    check_kernel_tensor("o", o)
    check_kernel_tensor("dO", g)
    if not q.dtype == o.dtype == g.dtype:
        raise ValueError(f"o and dO must have q's dtype {q.dtype}; got {o.dtype}, {g.dtype}")
    if lse.dtype != torch.float32:
        raise ValueError(f"flash_attention_bwd kernel takes an fp32 lse; got {lse.dtype}")
    if not lse.is_contiguous():
        raise ValueError(f"lse must be a contiguous [B, H, Sq] tensor; strides {lse.stride()}")


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


def flash_attention_bwd_blocked(q, k, v, o, lse, g, scale=None):
    """The CUDA kernels' schedule, emulated in PyTorch on any device: the dq
    kernel's walk over 64-key tiles (dq summed in fp32 in key-tile order)
    and the dk/dv kernel's walk over 64-query tiles (dk, dv summed in fp32
    in query-tile order), with P and dS rounded to bf16 (fp16 for fp16
    inputs, dS scaled by 2^e of :func:`ds_exponent` first) where the kernels
    feed them to ``wgmma``, and the logits in log2 units against
    ``lse·log2 e``.  Same signature and contract as
    :func:`flash_attention_bwd_reference`; the card tests and the smoke hold
    the kernels to it, the CPU tests hold it to the plain version and to
    JAX."""
    _check_shapes(q, k, v, o, lse, g)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    c = scale * LOG2E
    tile = KERNEL_TILE_ROWS
    qf, kf, vf, gf = (x.float().transpose(1, 2) for x in (q, k, v, g))  # [B, H, S, d]
    delta = row_delta(o, g)  # [B, H, Sq], the pre-pass
    lse2 = lse.float() * LOG2E
    low = torch.float16 if q.dtype == torch.float16 else torch.bfloat16
    bf16 = lambda x: x.to(low).float()  # noqa: E731
    ds_up = 2.0 ** int(ds_exponent(v, g)) if q.dtype == torch.float16 else 1.0

    dq = torch.zeros_like(qf)
    for k0 in range(0, kf.shape[2], tile):  # the dq kernel: key tiles in order
        kt, vt = kf[:, :, k0:k0 + tile], vf[:, :, k0:k0 + tile]
        p = torch.exp2(torch.matmul(qf, kt.transpose(-1, -2)) * c - lse2[..., None])
        dp = torch.matmul(gf, vt.transpose(-1, -2))
        dq += torch.matmul(bf16(p * (dp - delta[..., None]) * ds_up), kt)

    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    for q0 in range(0, qf.shape[2], tile):  # the dk/dv kernel: query tiles in order
        qt, gt = qf[:, :, q0:q0 + tile], gf[:, :, q0:q0 + tile]
        pt = torch.exp2(torch.matmul(kf, qt.transpose(-1, -2)) * c - lse2[:, :, None, q0:q0 + tile])
        dpt = torch.matmul(vf, gt.transpose(-1, -2))
        dv += torch.matmul(bf16(pt), gt)
        dk += torch.matmul(bf16(pt * (dpt - delta[:, :, None, q0:q0 + tile]) * ds_up), qt)
    out_scale = scale / ds_up
    return ((dq * out_scale).transpose(1, 2).to(q.dtype), (dk * out_scale).transpose(1, 2).to(k.dtype),
            dv.transpose(1, 2).to(v.dtype))


def bwd_workspace(q: torch.Tensor) -> torch.Tensor:
    """The kernels' fp32 workspace ``[2, B·H, Sq_pad]`` (lse·log2 e and D,
    rows padded to whole 64-row tiles), written by the pre-pass; the fp32
    kernels' ``[2, B·H, Sq]``."""
    if q.dtype == torch.float32:
        return attention_f32.bwd_workspace(q)
    b, sq, h, _ = q.shape
    sq_pad = -(-sq // KERNEL_TILE_ROWS) * KERNEL_TILE_ROWS
    return torch.empty((2, b * h, sq_pad), dtype=torch.float32, device=q.device)


def _launch(q, k, v, o, g, lse, dq, dk, dv, scale: float, workspace, parts: int = ALL_PARTS) -> None:
    """Launch ``parts`` of one backward (all three for a call; the smoke
    times them one at a time on a workspace a full launch has filled)."""
    b, sq, h, _ = q.shape
    skv = k.shape[1]
    if q.dtype == torch.float32:
        attention_f32.launch_bwd(q, k, v, o, g, lse, dq, dk, dv, scale, workspace=workspace, parts=parts)
    else:
        strides = [s for t in (q, k, v, o, g, dq, dk, dv) for s in t.stride()[:3]]
        ds_exp = ds_exponent(v, g) if q.dtype == torch.float16 else None
        native.launch(LIB, ENTRY[q.dtype], q.device, ptr(q), ptr(k), ptr(v), ptr(o), ptr(g), ptr(lse), ptr(ds_exp),
                      ptr(workspace[0]), ptr(workspace[1]), ptr(dq), ptr(dk), ptr(dv), b, h, sq, skv, *strides,
                      scale, int(parts))
    native.count("flash_attention_bwd", q.dtype)


def _flash_attention_bwd_cuda(q, k, v, o, lse, g, scale):
    check_bwd_kernel_inputs(q, k, v, o, lse, g)
    for t in (k, v, o, lse, g):
        if t.device != q.device:
            raise ValueError("q, k, v, o, lse, dO must be on one device")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=k.dtype, device=q.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=q.device)
    _launch(q, k, v, o, g, lse, dq, dk, dv, scale, bwd_workspace(q))
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

    CPU tensors take the plain version; CUDA tensors launch the kernels or
    raise (bf16, fp16 or fp32, and d = 64 only)."""
    devices = {t.device.type for t in (q, k, v, o, lse, g)}
    if devices == {"cpu"}:
        return flash_attention_bwd_reference(q, k, v, o, lse, g, scale)
    if devices == {"cuda"}:
        return _flash_attention_bwd_cuda(q, k, v, o, lse, g, scale)
    raise ValueError(f"flash_attention_bwd needs all its inputs on the CPU or all on CUDA, got {devices}")
