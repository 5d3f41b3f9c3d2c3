"""Kernel B3: non-causal flash attention with an int8 q·kᵀ, a CUDA C++
kernel for Hopper.

Replaces ``s2v_tpu/ops/pallas/int8_attention.py::flash_attention_qk_int8``
(the Pallas kernel ``_int8_kernel``), opt-in for int8 serving.  The CUDA
source is ``s2v_torch/csrc/int8_attention.cu``; it is compiled with ``nvcc``
for ``sm_90a`` into ``build/`` on the first CUDA call and bound with
``ctypes``.

The pre-pass (torch ops, as the JAX package runs it in XLA outside its
kernel): ``scale·q`` and ``k`` get one symmetric int8 scale each over the
WHOLE tensor, every batch row and head together, so the uncond and cond
halves of batched CFG share it; ``dq = qs·ks`` stays a one-element fp32
device tensor that the kernel reads through a pointer (no host sync).  The
kernel computes ``s = (q_i8 · k_i8) · dq`` exactly in int32 on the tensor
cores, an online softmax in fp32, and P·V in bf16 with fp32 accumulation.

Bound on an H100 SXM at the main-path shape (B=2, H=48, S=19,126, d=64):
q·kᵀ is 2·B·H·S²·d = 4.5·10¹² int8 operations (2.27 ms at 1,979 TOPS) and
P·V 4.5·10¹² bf16 operations (4.55 ms at 989 TFLOP/s): 6.8 ms, compute-bound
(q/k/v/o traffic is under 1 GB).

``flash_attention_qk_int8`` dispatches on the device of its inputs: CPU
tensors go to :func:`flash_attention_qk_int8_reference`, the plain PyTorch
version; CUDA tensors launch the kernel or raise.
``flash_attention_qk_int8.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from s2v_torch.kernels.flash_attention import REFERENCE_CHUNK, check_kernel_inputs
from s2v_torch.ops.quant import INV_127
from s2v_torch.utils import native_build

SOURCE = native_build.CSRC_DIR / "int8_attention.cu"
# an fp32 product of int8-valued operands is exact while 127²·d < 2²⁴
MAX_EXACT_FP32_HEAD_DIM = 1040
_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(native_build.build_one(SOURCE)))
        fn = lib.s2v_int8_attention_fwd
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [vp] * 5 + [i32] * 4 + [i64] * 12 + [vp]
        fn.restype = i32
        _lib = lib
    return _lib


def quantize_tensor_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x`` -> (int8 values, fp32 scalar scale) with one symmetric scale
    over the whole tensor (JAX ``_quantize_tensor``): ``amax|x| · (1/127)``
    (1 for an all-zero tensor), then ``clamp(round(x / scale), ±127)``."""
    amax = torch.linalg.vector_norm(x, float("inf")).float()
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


def launch_int8(q_i8, k_i8, v, o, dq) -> None:
    """One launch of the kernel on int8 q/k (any strides with contiguous,
    16-byte aligned rows), bf16 v and o, and the device scalar ``dq``."""
    b, sq, h, _ = q_i8.shape
    strides = [s for t in (q_i8, k_i8, v, o) for s in t.stride()[:3]]
    err = _library().s2v_int8_attention_fwd(
        *(ctypes.c_void_p(t.data_ptr()) for t in (q_i8, k_i8, v, o, dq)),
        b, h, sq, k_i8.shape[1], *strides,
        ctypes.c_void_p(torch.cuda.current_stream(q_i8.device).cuda_stream),
    )
    if err != 0:
        raise RuntimeError(f"flash_attention_qk_int8 kernel launch failed: cudaError {err}")
    flash_attention_qk_int8.launches += 1


def _flash_attention_qk_int8_cuda(q, k, v, scale):
    _check_shapes(q, k, v)
    check_kernel_inputs(q, k, v)
    for t in (k, v):
        if t.device != q.device:
            raise ValueError("q, k, v must be on one device")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    q_i8, k_i8, dq = int8_prepass(q, k, scale)
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    # fresh, contiguous int8 rows of 64 bytes: aligned for the 16-byte copies
    launch_int8(q_i8.contiguous(), k_i8.contiguous(), v, o, dq)
    return o


def flash_attention_qk_int8(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: Optional[float] = None
) -> torch.Tensor:
    """softmax(scale·q·kᵀ)·v, non-causal, with per-tensor int8 q and k for
    the logits.  q ``[B, Sq, H, d]``, k/v ``[B, Skv, H, d]`` -> ``[B, Sq, H,
    d]`` in q's dtype; no lse, no mask.

    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise (bf16 and d = 64 only)."""
    devices = {t.device.type for t in (q, k, v)}
    if devices == {"cpu"}:
        return flash_attention_qk_int8_reference(q, k, v, scale)
    if devices == {"cuda"}:
        return _flash_attention_qk_int8_cuda(q, k, v, scale)
    raise ValueError(f"flash_attention_qk_int8 needs q, k, v all on the CPU or all on CUDA, got {devices}")


flash_attention_qk_int8.launches = 0
