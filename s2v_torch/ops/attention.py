"""Joint attention over the ``[text | ref | video]`` sequence
(counterpart of ``s2v_tpu/ops/attention.py``).

Backends:
  * ``flash`` — :func:`flash_attention_trainable`: kernel B1
    (``s2v_torch.kernels.flash_attention``) in the bounded softmax mode, the
    JAX package's default, and under autograd kernel B2
    (``s2v_torch.kernels.flash_attention_bwd``) for the backward; on CPU
    tensors both kernels' plain versions run instead.
  * ``plain`` — exact fp32 softmax attention in PyTorch ops (B1's plain
    version in the online mode, differentiated by autograd); the CPU
    analogue of the JAX ``xla`` backend.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from s2v_torch.kernels.flash_attention import flash_attention, flash_attention_reference
from s2v_torch.kernels.flash_attention_bwd import flash_attention_bwd
from s2v_torch.ops.norms import layer_norm
from s2v_torch.ops.quant import dense
from s2v_torch.ops.rope import apply_rotary_emb

ATTENTION_BACKENDS = ("auto", "flash", "plain")
FLASH_SOFTMAX_MODE = "bounded"


def resolve_attention_backend(backend: str, device: torch.device) -> str:
    """``auto`` -> ``flash`` on CUDA, ``plain`` on the CPU."""
    if backend not in ATTENTION_BACKENDS:
        raise ValueError(f"unknown attention backend {backend!r}; expected one of {ATTENTION_BACKENDS}")
    if backend != "auto":
        return backend
    return "flash" if torch.device(device).type == "cuda" else "plain"


class _FlashAttention(torch.autograd.Function):
    """Flash attention both ways (``s2v_tpu/ops/attention.py:344-383``):
    the forward is B1 with lse, saving q, k, v, o and the true lse; the
    backward is B2, which recomputes P from the lse."""

    @staticmethod
    def forward(ctx, q, k, v):
        o, lse = flash_attention(q, k, v, return_lse=True, softmax_mode=FLASH_SOFTMAX_MODE)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, lse = ctx.saved_tensors
        return flash_attention_bwd(q, k, v, o, lse, g.contiguous())


def flash_attention_trainable(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Differentiable flash attention, ``[B, S, H, d]`` in and out.  Without
    autograd (no input needs a grad, or grad mode is off) it is one B1 call
    without lse, exactly what inference runs."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v)
    return flash_attention(q, k, v, softmax_mode=FLASH_SOFTMAX_MODE)


def qkv_projections(params: dict, x: torch.Tensor, num_heads: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``[B, S, D]`` -> per-head q, k, v ``[B, S, H, d]`` through the fused
    ``qkv`` linear (weight ``[3D, D]``, rows q | k | v)."""
    b, s, d = x.shape
    q, k, v = dense(params["qkv"], x).chunk(3, dim=-1)
    shape = (b, s, num_heads, d // num_heads)
    return q.reshape(shape), k.reshape(shape), v.reshape(shape)


def joint_attention(
    params: dict,
    x: torch.Tensor,
    num_heads: int,
    rope_cos: Optional[torch.Tensor] = None,
    rope_sin: Optional[torch.Tensor] = None,
    qk_norm_eps: float = 1e-6,
    backend: str = "plain",
) -> torch.Tensor:
    """Full-sequence self attention: fused qkv, fp32-statistics qk-LayerNorm,
    segmented RoPE (``[S, d/2]`` tables, or None), attention, output linear."""
    b, s, d = x.shape
    q, k, v = qkv_projections(params, x, num_heads)
    q = layer_norm(q, params["norm_q"]["weight"], params["norm_q"]["bias"], qk_norm_eps)
    k = layer_norm(k, params["norm_k"]["weight"], params["norm_k"]["bias"], qk_norm_eps)
    if rope_cos is not None:
        q = apply_rotary_emb(q, rope_cos[:, None, :], rope_sin[:, None, :])
        k = apply_rotary_emb(k, rope_cos[:, None, :], rope_sin[:, None, :])

    fp16_in = q.dtype == torch.float16
    if fp16_in:
        # fp16 storage is upcast once before attention and cast back after
        q, k, v = (t.float() for t in (q, k, v))
    if backend == "flash":
        out = flash_attention_trainable(q, k, v)
    elif backend == "plain":
        out = flash_attention_reference(q, k, v)
    else:
        raise ValueError(f"unresolved attention backend {backend!r}")
    if fp16_in:
        out = out.to(torch.float16)
    return dense(params["to_out"], out.reshape(b, s, d))
