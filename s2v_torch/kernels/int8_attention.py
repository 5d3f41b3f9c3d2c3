"""Kernel B3: non-causal flash attention with an int8 q·kᵀ, CUDA C++
kernels for Hopper.

Replaces ``s2v_tpu/ops/pallas/int8_attention.py::flash_attention_qk_int8``
(the Pallas kernel ``_int8_kernel``, and the XLA quantize its wrapper runs
before it), opt-in for int8 serving.  The CUDA source is
``s2v_torch/csrc/int8_attention.cu`` (on the shared Hopper layer
``csrc/hopper.cuh``); it is compiled with ``nvcc`` for ``sm_90a`` into
``build/`` on the first CUDA call and bound with ``ctypes``.

The pre-pass: ``scale·q`` and ``k`` get one symmetric int8 scale each over
the WHOLE tensor, every batch row and head together, so the uncond and cond
halves of batched CFG share it; ``dq = qs·ks`` stays a one-element fp32
device tensor that the main kernel reads through a pointer (no host sync).
On CUDA it is two hand-written kernels (an amax reduction, then the
quantize), equal bit for bit to :func:`int8_prepass`, the plain version.
The main kernel computes ``s = (q_i8 · k_i8) · dq`` exactly in int32 with
``wgmma`` s8 on tiles that TMA loads, an online softmax in fp32, and P·V in
bf16 with fp32 accumulation (``wgmma`` bf16).

Bound on an H100 SXM at the main-path shape (B=2, H=48, S=19,126, d=64):
q·kᵀ is 2·B·H·S²·d = 4.5·10¹² int8 operations (2.27 ms at 1,979 TOPS) and
P·V 4.5·10¹² bf16 operations (4.55 ms at 989 TFLOP/s), 6.8 ms on the tensor
cores; the B·H·S² = 3.5·10¹⁰ exponentials take 8.4 ms on the SFUs (16 a
clock per SM at 1.98 GHz), which bounds the kernel.  The design keeps the
SFUs busy: four warpgroups share an SM (two blocks of two, each warpgroup
running its own 64 query rows, so one's exponentials overlap another's
products), the int32 logits turn into fp32 without a conversion instruction
(which would run on the SFUs too), and masking runs on the ragged last key
tile only.

``flash_attention_qk_int8`` dispatches on the device of its inputs: CPU
tensors go to :func:`flash_attention_qk_int8_reference`, the plain PyTorch
version; CUDA tensors launch the kernels or raise.  ``native.count``
records each main-kernel launch as ``flash_attention_qk_int8`` (by element
type) and each pre-pass launch (both kernels) as
``flash_attention_qk_int8_prepass``.
:func:`flash_attention_qk_int8_blocked` emulates the main kernel's schedule
in plain PyTorch; the card tests hold the kernel to it.

Element types of q, k, v: bf16 (the 5b models) and fp16 (the 2b family), the
kernels templated on the type with two C entry points each (``ENTRY``,
``PREPASS_ENTRY``), and fp32 (``--dtype float32``, as the JAX kernel takes
it).  The pre-pass reads each into fp32 exactly, so its int8 values and dq
are the same arithmetic for all three (fp32: ``s2v_int8_prepass_f32``); the
bf16/fp16 main kernel rounds P to v's type for P·V, in fp16 as B1 does (the
softmax is online: P ≤ 1 needs no offset).  The fp32 main kernel is
``csrc/attention_f32.cu``'s ``s2v_flash_attention_qk_int8_fwd_f32``
(:func:`s2v_torch.kernels.attention_f32.launch_int8_fwd`): the same exact
int32 logits (``wgmma`` m64n64k32 s8 on TMA-loaded 64-key tiles), an online
softmax in fp32 and P·V in 3xTF32 (``wgmma`` tf32) from v's big and small
transposed planes, each tile's sum from zero added in fp32; nothing is
rounded below fp32.  Its bound at the main shape: the logits 2.3 ms, the
exponentials 8.4 ms, P·V 27.2 ms at the 3-pass TF32 floor (3 × 4.5·10¹²
operations at 495 TFLOP/s).
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
from s2v_torch.ops.quant import INV_127
from s2v_torch.utils import native_build

SOURCE = native_build.CSRC_DIR / "int8_attention.cu"
# the C entry points of each element type: the main kernel's and the pre-pass's
# (fp32's main kernel is attention_f32.cu's)
ENTRY = {torch.bfloat16: "s2v_int8_attention_fwd", torch.float16: "s2v_int8_attention_fwd_f16"}
PREPASS_ENTRY = {torch.bfloat16: "s2v_int8_prepass", torch.float16: "s2v_int8_prepass_f16",
                 torch.float32: "s2v_int8_prepass_f32"}
# an fp32 product of int8-valued operands is exact while 127²·d < 2²⁴
MAX_EXACT_FP32_HEAD_DIM = 1040
# query rows per block and keys per tile of the main kernel (fp32: 64-key tiles)
KERNEL_QUERY_TILE = 128
KERNEL_KEY_TILE = 128
KERNEL_KEY_TILE_F32 = attention_f32.KERNEL_ROWS
LIB = native_build.Library(SOURCE, {**{name: [PTR] * 5 + [I32] * 4 + [I64] * 12 + [STREAM] for name in ENTRY.values()},
                              **{name: [PTR] * 6 + [I32] * 4 + [I64] * 6 + [F32, STREAM]
                                 for name in PREPASS_ENTRY.values()},
                              "s2v_int8_qk_tile": [PTR] * 3 + [STREAM],
                              "s2v_int8_attention_fwd_smem_bytes": []})


def kernel_smem_bytes() -> int:
    """Dynamic shared memory a block of the main kernel asks for."""
    return LIB.entry("s2v_int8_attention_fwd_smem_bytes")()


def quantize_tensor_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x`` -> (int8 values, fp32 scalar scale) with one symmetric scale
    over the whole tensor (JAX ``_quantize_tensor``): in fp32,
    ``amax|x| · (1/127)`` (1 for an all-zero tensor), then
    ``clamp(round(x / scale), ±127)``, rounding half to even."""
    x = x.float()  # a bf16 x would otherwise divide, and round the quotient, in bf16
    amax = torch.linalg.vector_norm(x, float("inf"))
    scale = torch.where(amax == 0, torch.ones_like(amax), amax * INV_127)
    return torch.div(x, scale).round_().clamp_(-127, 127).to(torch.int8), scale


def int8_prepass(q: torch.Tensor, k: torch.Tensor, scale: float):
    """(q_i8, k_i8, dq): ``scale·q`` and ``k`` quantized per tensor, and the
    logit dequant ``dq = qs·ks`` as a one-element fp32 tensor on their device."""
    q_i8, qs = quantize_tensor_int8(q.float() * scale)
    k_i8, ks = quantize_tensor_int8(k)
    return q_i8, k_i8, (qs * ks).reshape(1)


def _check_shapes(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be [B, S, H, d]")
    if k.shape != v.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} differ")
    if q.shape[0] != k.shape[0] or q.shape[2:] != k.shape[2:]:
        raise ValueError(f"q {tuple(q.shape)} does not match k {tuple(k.shape)}")
    if k.shape[1] == 0:
        raise ValueError("int8 attention needs at least one key")
    if q.shape[-1] > MAX_EXACT_FP32_HEAD_DIM:
        raise ValueError(f"head dim {q.shape[-1]} > {MAX_EXACT_FP32_HEAD_DIM}: the plain version's logits "
                         "would not be exact")


def flash_attention_qk_int8_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: Optional[float] = None
) -> torch.Tensor:
    """The plain PyTorch version of the kernel, same contract: q ``[B, Sq,
    H, d]``, k/v ``[B, Skv, H, d]`` -> ``[B, Sq, H, d]`` in q's dtype.

    The same pre-pass; logits ``(q_i8 · k_i8) · dq`` with the int8 product
    exact (int-valued fp32 operands, |q·k| ≤ 127²·d < 2²⁴ for d ≤ 1,040;
    with TF32 matmuls off, the default, on a card); an fp32 softmax chunked
    over queries; fp32 P·V."""
    _check_shapes(q, k, v)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    q_i8, k_i8, dq = int8_prepass(q, k, scale)
    kf = k_i8.float().permute(0, 2, 3, 1)  # [B, H, d, Skv]
    vf = v.float().transpose(1, 2)  # [B, H, Skv, d]
    outs = []
    for c0 in range(0, q.shape[1], REFERENCE_CHUNK):
        qc = q_i8[:, c0:c0 + REFERENCE_CHUNK].float().transpose(1, 2)  # [B, H, chunk, d]
        s = torch.matmul(qc, kf) * dq
        p = torch.exp(s - s.amax(-1, keepdim=True))
        l = p.sum(-1, keepdim=True)
        o = torch.matmul(p, vf) / torch.where(l == 0, torch.ones_like(l), l)
        outs.append(o.transpose(1, 2).to(q.dtype))
    return torch.cat(outs, dim=1)


def flash_attention_qk_int8_blocked(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: Optional[float] = None
) -> torch.Tensor:
    """The CUDA kernel's schedule, emulated in plain PyTorch on any device:
    the same pre-pass; 128-row query tiles, each walking 128-key tiles in
    order; logits exact in int32 (int-valued fp32 products); an online
    softmax in exp2 with ``c = dq·log2 e``, the keys past Skv in the last
    tile at −inf; the row sums of fp32 P, and P rounded to v's type (bf16,
    or fp16 for fp16 inputs) before P·V (fp32 accumulation).  Same signature and contract as
    :func:`flash_attention_qk_int8_reference`; the card tests and the smoke
    hold the kernel to it, the CPU tests hold it to the plain version and
    to JAX.  Nothing on the main path calls it.  fp32 inputs take the fp32
    kernel's schedule (:func:`_blocked_f32`)."""
    _check_shapes(q, k, v)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    q_i8, k_i8, dq = int8_prepass(q, k, scale)
    if v.dtype == torch.float32:
        return _blocked_f32(q_i8, k_i8, v, dq)
    c = dq * LOG2E  # fp32, as the kernel's *dq * log2(e)
    skv, tile = k.shape[1], KERNEL_KEY_TILE
    pad = -skv % tile  # the last tile's keys past Skv: zeros, as TMA fills them
    kf = torch.nn.functional.pad(k_i8.float(), (0, 0, 0, 0, 0, pad)).permute(0, 2, 3, 1)  # [B, H, d, Skv_pad]
    vf = torch.nn.functional.pad(v.float(), (0, 0, 0, 0, 0, pad)).transpose(1, 2)  # [B, H, Skv_pad, d]
    low = torch.float16 if v.dtype == torch.float16 else torch.bfloat16
    bf16 = lambda x: x.to(low).float()  # noqa: E731
    outs = []
    for q0 in range(0, q.shape[1], KERNEL_QUERY_TILE):
        qt = q_i8[:, q0:q0 + KERNEL_QUERY_TILE].float().transpose(1, 2)  # [B, H, rows, d]
        m = torch.full(qt.shape[:3], -1e30, dtype=torch.float32, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros(*qt.shape[:3], v.shape[-1], dtype=torch.float32, device=q.device)
        for k0 in range(0, skv, tile):
            s = torch.matmul(qt, kf[..., k0:k0 + tile])
            if k0 + tile > skv:
                s[..., skv - k0:] = float("-inf")
            new = torch.maximum(m, s.amax(-1) * c)
            alpha = torch.exp2(m - new)
            p = torch.exp2(s * c - new[..., None])
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.matmul(bf16(p), vf[:, :, k0:k0 + tile])
            m = new
        inv = torch.where(l > 0, 1.0 / l, torch.zeros_like(l))
        outs.append((acc * inv[..., None]).transpose(1, 2).to(q.dtype))
    return torch.cat(outs, dim=1)


def _blocked_f32(q_i8, k_i8, v, dq):
    """The fp32 main kernel's schedule: 64-key tiles in order, the logits
    exact, an online softmax in exp2 (running max from -1e30, keys past Skv
    at -inf), each tile's P·V in 3xTF32 from zero (``mm_3xtf32``) added to
    the rescaled sum in fp32, o = sum / l (0 where l = 0)."""
    c = dq * LOG2E
    skv, tile = k_i8.shape[1], KERNEL_KEY_TILE_F32
    kf = k_i8.float().permute(0, 2, 3, 1)  # [B, H, d, Skv]
    vf = v.transpose(1, 2)  # [B, H, Skv, d]
    qt = q_i8.float().transpose(1, 2)  # [B, H, Sq, d]: rows are independent, so the 128-row blocks need no loop
    m = torch.full(qt.shape[:3], -1e30, dtype=torch.float32, device=v.device)
    l = torch.zeros_like(m)
    acc = torch.zeros(*qt.shape[:3], v.shape[-1], dtype=torch.float32, device=v.device)
    for k0 in range(0, skv, tile):
        s = torch.matmul(qt, kf[..., k0:k0 + tile])
        new = torch.maximum(m, s.amax(-1) * c)
        alpha = torch.exp2(m - new)
        p = torch.exp2(s * c - new[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + attention_f32.mm_3xtf32(p, vf[:, :, k0:k0 + tile])
        m = new
    out = torch.where(l[..., None] > 0, acc / torch.where(l > 0, l, torch.ones_like(l))[..., None],
                      torch.zeros_like(acc))
    return out.transpose(1, 2).contiguous()


def launch_int8_prepass(q: torch.Tensor, k: torch.Tensor, scale: float):
    """The pre-pass kernels on bf16, fp16 or fp32 q, k of one type (rows
    contiguous and 16-byte aligned): (q_i8, k_i8, dq) as
    :func:`int8_prepass` returns them, bit for bit, with q_i8 and k_i8
    contiguous."""
    _check_shapes(q, k, k)
    for name, t in (("q", q), ("k", k)):
        check_kernel_tensor(name, t)
    if q.dtype != k.dtype:
        raise ValueError(f"q and k must have one dtype; got {q.dtype}, {k.dtype}")
    q_i8 = torch.empty(q.shape, dtype=torch.int8, device=q.device)
    k_i8 = torch.empty(k.shape, dtype=torch.int8, device=q.device)
    amax = torch.empty(2, dtype=torch.float32, device=q.device)  # workspace
    dq = torch.empty(1, dtype=torch.float32, device=q.device)
    b, sq, h, _ = q.shape
    native.launch(LIB, PREPASS_ENTRY[q.dtype], q.device, *(ptr(t) for t in (q, k, q_i8, k_i8, amax, dq)), b, h,
                  sq, k.shape[1], *q.stride()[:3], *k.stride()[:3], scale)
    native.count("flash_attention_qk_int8_prepass")
    return q_i8, k_i8, dq


def launch_int8(q_i8, k_i8, v, o, dq) -> None:
    """One launch of the main kernel on int8 q/k and bf16, fp16 or fp32 v, o
    (strides with contiguous, 16-byte aligned rows, as TMA needs; fp32:
    q_i8 and k_i8 contiguous, as the pre-pass writes them) and the device
    scalar ``dq``."""
    if v.dtype == torch.float32:
        attention_f32.launch_int8_fwd(q_i8, k_i8, v, o, dq)
    else:
        b, sq, h, _ = q_i8.shape
        strides = [s for t in (q_i8, k_i8, v, o) for s in t.stride()[:3]]
        native.launch(LIB, ENTRY[v.dtype], q_i8.device, *(ptr(t) for t in (q_i8, k_i8, v, o, dq)), b, h, sq,
                      k_i8.shape[1], *strides)
    native.count("flash_attention_qk_int8", v.dtype)


def int8_qk_tile(q_i8: torch.Tensor, k_i8: torch.Tensor) -> torch.Tensor:
    """One s8 ``wgmma`` tile through the main kernel's TMA maps and
    descriptors: ``q_i8 [64, 64] · k_i8[128, 64]ᵀ`` in int32, on the card
    (a check of the 64-byte-swizzle layer against an integer matmul)."""
    if q_i8.shape != (64, 64) or k_i8.shape != (128, 64) or q_i8.dtype != torch.int8 or k_i8.dtype != torch.int8:
        raise ValueError("int8_qk_tile takes int8 q [64, 64] and k [128, 64]")
    q_i8, k_i8 = q_i8.contiguous(), k_i8.contiguous()
    out = torch.empty(64, 128, dtype=torch.int32, device=q_i8.device)
    native.launch(LIB, "s2v_int8_qk_tile", q_i8.device, ptr(q_i8), ptr(k_i8), ptr(out))
    return out


def _flash_attention_qk_int8_cuda(q, k, v, scale):
    _check_shapes(q, k, v)
    check_kernel_inputs(q, k, v)
    for t in (k, v):
        if t.device != q.device:
            raise ValueError("q, k, v must be on one device")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    q_i8, k_i8, dq = launch_int8_prepass(q, k, scale)
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    launch_int8(q_i8, k_i8, v, o, dq)
    return o


def flash_attention_qk_int8(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: Optional[float] = None
) -> torch.Tensor:
    """softmax(scale·q·kᵀ)·v, non-causal, with per-tensor int8 q and k for
    the logits.  q ``[B, Sq, H, d]``, k/v ``[B, Skv, H, d]`` -> ``[B, Sq, H,
    d]`` in q's dtype; no lse, no mask.

    CPU tensors take the plain version; CUDA tensors launch the pre-pass
    and main kernels or raise (bf16, fp16 or fp32, and d = 64 only)."""
    devices = {t.device.type for t in (q, k, v)}
    if devices == {"cpu"}:
        return flash_attention_qk_int8_reference(q, k, v, scale)
    if devices == {"cuda"}:
        return _flash_attention_qk_int8_cuda(q, k, v, scale)
    raise ValueError(f"flash_attention_qk_int8 needs q, k, v all on the CPU or all on CUDA, got {devices}")
