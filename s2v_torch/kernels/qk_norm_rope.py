"""The q/k LayerNorms and RoPE of the DiT's joint attention in one CUDA kernel.

Replaces no TPU kernel: the JAX package leaves this chain to XLA, which
fuses it.  In PyTorch the chain (``ops/norms.py::layer_norm`` on q and on
k, then ``ops/rope.py::apply_rotary_emb`` on each) runs as about twenty
elementwise and reduction passes over q and k.  The CUDA source is
``s2v_torch/csrc/qk_norm_rope.cu``, compiled with ``nvcc`` for ``sm_90a``
into ``build/`` on the first CUDA call and bound with ``ctypes``.

Bound on an H100 SXM: memory.  One read and one write of q and k, 0.94 GB a
call at the 5b shape (B=2, S=19,126, H=48, d=64; 0.28 ms at 3.35 TB/s) and
0.59 GB at the 2b shape (H=30; 0.18 ms).

:func:`qk_norm_rope` takes the kernel when it can: q and k CUDA tensors of
bf16 or fp16 with d = 64, and no gradient needed (grad mode off, or none of
q, k and the norm params requiring one); the kernel has no backward, so the
trainers keep the plain chain.  Every other call, on the CPU, in fp32 or
under autograd, runs :func:`qk_norm_rope_reference`, the plain chain
itself.  ``native.count`` records each launch as ``qk_norm_rope`` (by
element type) and each call that ran the plain chain as
``qk_norm_rope_plain``.

The kernel computes in fp32 throughout and rounds once (see
:func:`qk_norm_rope_emulated`); the plain chain applies the norm in the
storage dtype, rounding after each op.  The two agree within the repo's
bf16/fp16 limits (2^-6 of the largest value, 1e-2 relative L2).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from s2v_torch.kernels import native
from s2v_torch.kernels.native import F32, I32, I64, PTR, STREAM, ptr
from s2v_torch.ops.norms import layer_norm
from s2v_torch.ops.rope import apply_rotary_emb
from s2v_torch.utils import native_build
from s2v_torch.utils.device import needs_grad

HEAD_DIM = 64
SOURCE = native_build.CSRC_DIR / "qk_norm_rope.cu"
# the C entry point of each element type
ENTRY = {torch.bfloat16: "s2v_qk_norm_rope", torch.float16: "s2v_qk_norm_rope_f16"}
LIB = native_build.Library(SOURCE, {name: [PTR] * 10 + [I32] * 3 + [I64] * 6 + [F32, STREAM]
                                    for name in ENTRY.values()})


def qk_norm_rope_reference(q: torch.Tensor, k: torch.Tensor, norm_q: dict, norm_k: dict, eps: float,
                           cos: Optional[torch.Tensor] = None,
                           sin: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain chain: ``layer_norm`` of q and of k over d with their
    norms' ``weight`` and ``bias``, then, with ``[S, d/2]`` tables,
    ``apply_rotary_emb`` of each.  ``[B, S, H, d]`` in, the same out."""
    q = layer_norm(q, norm_q["weight"], norm_q["bias"], eps)
    k = layer_norm(k, norm_k["weight"], norm_k["bias"], eps)
    if cos is not None:
        q = apply_rotary_emb(q, cos[:, None, :], sin[:, None, :])
        k = apply_rotary_emb(k, cos[:, None, :], sin[:, None, :])
    return q, k


def qk_norm_rope_emulated(q: torch.Tensor, k: torch.Tensor, norm_q: dict, norm_k: dict, eps: float,
                          cos: Optional[torch.Tensor] = None,
                          sin: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's arithmetic in PyTorch ops: fp32 statistics, apply and
    rotation, one rounding to the storage dtype at the end (the kernel's
    sums run in another order, and it fuses multiply-adds).  The norm
    params are taken in the storage dtype, as the plain chain takes them."""

    def one(x, norm):
        xf = x.float()
        centred = xf - xf.mean(-1, keepdim=True)
        rstd = torch.reciprocal(torch.sqrt(centred.square().mean(-1, keepdim=True) + eps))
        y = centred * rstd * norm["weight"].to(x.dtype).float() + norm["bias"].to(x.dtype).float()
        if cos is not None:
            pairs = y.unflatten(-1, (-1, 2))
            even, odd = pairs[..., 0], pairs[..., 1]
            c, s = cos.float()[:, None, :], sin.float()[:, None, :]
            y = torch.stack([even * c - odd * s, odd * c + even * s], dim=-1).flatten(-2)
        return y.to(x.dtype)

    return one(q, norm_q), one(k, norm_k)


def _check_tensor(name: str, t: torch.Tensor) -> None:
    if t.dtype not in ENTRY:
        raise ValueError(f"the qk_norm_rope kernel takes bfloat16 or float16; {name} is {t.dtype}")
    if t.dim() != 4 or t.shape[-1] != HEAD_DIM:
        raise ValueError(f"the qk_norm_rope kernel takes [B, S, H, {HEAD_DIM}]; {name} is {tuple(t.shape)}")
    if t.stride(-1) != 1 or any((s * t.element_size()) % 16 for s in t.stride()[:-1]):
        raise ValueError(f"{name} needs a contiguous last dim and 16-byte aligned rows; strides {t.stride()}")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must start on a 16-byte boundary; its storage offset is {t.storage_offset()}")


def check_kernel_inputs(q: torch.Tensor, k: torch.Tensor, norm_q: dict, norm_k: dict,
                        cos: Optional[torch.Tensor] = None, sin: Optional[torch.Tensor] = None) -> None:
    """Raise unless the kernel takes these tensors: q and k ``[B, S, H, 64]``
    of one shape, bf16 or fp16, rows contiguous and 16-byte aligned (base
    pointer and strides: the kernel loads 16 bytes a thread); the norm
    params ``[64]``; the tables, when given, ``[S, 32]`` and 16-byte
    aligned.  Reads only metadata, so it is checked before any launch (and
    testable on the CPU)."""
    _check_tensor("q", q)
    _check_tensor("k", k)
    if k.shape != q.shape or k.dtype != q.dtype:
        raise ValueError(f"q {tuple(q.shape)} {q.dtype} and k {tuple(k.shape)} {k.dtype} differ")
    for name, norm in (("norm_q", norm_q), ("norm_k", norm_k)):
        for key in ("weight", "bias"):
            if tuple(norm[key].shape) != (HEAD_DIM,):
                raise ValueError(f"{name}['{key}'] must be [{HEAD_DIM}], got {tuple(norm[key].shape)}")
    if (cos is None) != (sin is None):
        raise ValueError("give both rotary tables or neither")
    want = (q.shape[1], HEAD_DIM // 2)
    for name, t in (("cos", cos), ("sin", sin)):
        if t is not None and tuple(t.shape) != want:
            raise ValueError(f"the rotary table {name} must be [S, d/2] = {list(want)}, got {tuple(t.shape)}")
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"the rotary table {name} must start on a 16-byte boundary")


def _kernel_engages(q: torch.Tensor, k: torch.Tensor, norm_q: dict, norm_k: dict) -> bool:
    """Whether a call takes the kernel: CUDA, bf16 or fp16, d = 64, and no
    gradient needed (the kernel has no backward)."""
    if not (q.is_cuda and k.is_cuda and q.dtype in ENTRY and q.shape[-1] == HEAD_DIM):
        return False
    return not needs_grad(q, k, norm_q["weight"], norm_q["bias"], norm_k["weight"], norm_k["bias"])


def _launch(q, k, norm_q, norm_k, eps, cos, sin):
    if any(t is not None and t.device != q.device for t in (k, cos, sin)):
        raise ValueError("q, k and the rotary tables must be on one device")
    # the params in q's dtype, as the plain chain applies them (a no-op for the model's own)
    wq, bq, wk, bk = (t.to(device=q.device, dtype=q.dtype).contiguous()
                      for t in (norm_q["weight"], norm_q["bias"], norm_k["weight"], norm_k["bias"]))
    cos, sin = (None if t is None else t.to(torch.float32).contiguous() for t in (cos, sin))
    check_kernel_inputs(q, k, {"weight": wq, "bias": bq}, {"weight": wk, "bias": bk}, cos, sin)
    b, s, h, d = q.shape
    out = torch.empty((2, b, s, h, d), dtype=q.dtype, device=q.device)
    q_out, k_out = out[0], out[1]
    native.launch(LIB, ENTRY[q.dtype], q.device, ptr(q), ptr(k), ptr(q_out), ptr(k_out), ptr(wq), ptr(bq), ptr(wk),
                  ptr(bk), ptr(cos), ptr(sin), b, s, h, *q.stride()[:3], *k.stride()[:3], eps)
    native.count("qk_norm_rope", q.dtype)
    return q_out, k_out


def qk_norm_rope(q: torch.Tensor, k: torch.Tensor, norm_q: dict, norm_k: dict, eps: float,
                 cos: Optional[torch.Tensor] = None,
                 sin: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """q and k ``[B, S, H, d]`` (views of the fused qkv output) LayerNormed
    over d with ``norm_q``/``norm_k`` (``{"weight", "bias"}``) and ``eps``,
    then, with ``[S, d/2]`` fp32 tables, rotated pair by pair.  Returns
    (q, k) in their dtype; the kernel's are contiguous.  See the module
    docstring for which calls take the kernel."""
    if _kernel_engages(q, k, norm_q, norm_k):
        return _launch(q, k, norm_q, norm_k, eps, cos, sin)
    native.count("qk_norm_rope_plain")
    return qk_norm_rope_reference(q, k, norm_q, norm_k, eps, cos, sin)
