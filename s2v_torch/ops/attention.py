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
  * ``flash_int8`` — :func:`int8_attention_inference_only`: kernel B3
    (``s2v_torch.kernels.int8_attention``), per-tensor int8 q·kᵀ, for int8
    serving (JAX ``pallas_int8``); inference only, its backward raises.
  * the windowed family (opt-in, approximate; ``window=(global_len,
    tokens_per_frame, w)``, see ``s2v_torch/ops/windowed_attention.py``):
    ``windowed`` — :func:`banded_attention_trainable`, kernel B4 forward and
    B5 backward (``s2v_torch.kernels.banded_attention``/``_bwd``);
    ``windowed_gather`` — the gather path on B1 (and B2 under autograd);
    ``windowed_plain`` — the gather path on the plain fp32 attention, the
    counterpart of JAX ``windowed_xla``;
    ``sp_windowed`` — sequence-parallel banded attention over the ``seq``
    dim of the active mesh (``s2v_torch.parallel``): kernel B6 per frame
    shard and B1 for the global queries forward, B7 and B2 backward
    (``s2v_torch/parallel/sp_attention.py``).  Without a mesh context it
    raises.

:func:`route_seq_backend` turns a single-card backend into its
sequence-parallel form on a ``seq`` ring above 1.  Of the JAX package's
sequence-parallel backends only ``sp_windowed`` is ported; ``sp_allgather``,
``sp_int8``, ``sp_ulysses`` and ``ring`` raise ``NotImplementedError``
(ROADMAP A.9), and no single-card backend stands in for them.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from s2v_torch.kernels.banded_attention import banded_flash_attention
from s2v_torch.kernels.banded_attention_bwd import banded_flash_attention_bwd
from s2v_torch.kernels.flash_attention import flash_attention, flash_attention_reference
from s2v_torch.kernels.flash_attention_bwd import flash_attention_bwd
from s2v_torch.kernels.int8_attention import flash_attention_qk_int8
from s2v_torch.ops.norms import layer_norm
from s2v_torch.ops.quant import dense
from s2v_torch.ops.rope import apply_rotary_emb
from s2v_torch.ops.windowed_attention import windowed_attention
from s2v_torch.parallel.context import active_axis, active_mesh
from s2v_torch.parallel.sp_attention import banded_allgather_attention_trainable

# backends that take the sliding temporal window (entry points configure its width)
WINDOWED_BACKENDS = ("windowed", "windowed_gather", "windowed_plain", "sp_windowed")
ATTENTION_BACKENDS = ("auto", "flash", "plain", "flash_int8") + WINDOWED_BACKENDS
# the JAX package's other sequence-parallel backends, not ported yet
UNPORTED_SEQ_BACKENDS = ("ring", "sp_allgather", "sp_int8", "sp_ulysses")
FLASH_SOFTMAX_MODE = "bounded"


def _unported(backend: str) -> NotImplementedError:
    return NotImplementedError(
        f"attention backend {backend!r} (sequence parallel) is not ported yet (ROADMAP A.9); of the "
        f"sequence-parallel backends the port has 'sp_windowed'")


def resolve_attention_backend(backend: str, device: torch.device) -> str:
    """``auto`` -> ``flash`` on CUDA, ``plain`` on the CPU."""
    if backend in UNPORTED_SEQ_BACKENDS:
        raise _unported(backend)
    if backend not in ATTENTION_BACKENDS:
        raise ValueError(f"unknown attention backend {backend!r}; expected one of {ATTENTION_BACKENDS}")
    if backend != "auto":
        return backend
    return "flash" if torch.device(device).type == "cuda" else "plain"


def route_seq_backend(backend: str, num_heads: int, seq_ring: int, tp_size: int = 1):
    """The sequence-parallel form of a backend on a mesh whose ``seq`` dim
    has ``seq_ring`` ranks (``s2v_tpu/ops/attention.py:57-101``, in the
    port's names: ``flash`` is JAX ``pallas``, ``flash_int8`` is
    ``pallas_int8``).  Returns ``(backend, reason)``, ``reason`` a line
    when a legality fallback rerouted the request, else None.

    ``windowed`` -> ``sp_windowed``; ``windowed_gather`` has no SP form and
    raises ``ValueError``; the routes to ``sp_allgather`` (from ``flash``
    and an illegal ``sp_ulysses``), ``sp_int8`` (from ``flash_int8``) and
    ``sp_ulysses`` raise ``NotImplementedError``: those wrappers are not
    ported (ROADMAP A.9).  A ring of 1 leaves every backend as it is."""
    if seq_ring <= 1:
        return backend, None
    reason = None
    routed = {"flash": "sp_allgather", "flash_int8": "sp_int8", "windowed": "sp_windowed"}.get(backend, backend)
    if backend == "windowed_gather":
        raise ValueError(
            "attention_backend='windowed_gather' has no sequence-parallel wrapper; under a seq mesh use "
            "'windowed' (reroutes to the sp_windowed banded kernel) or 'windowed_plain'")
    if backend == "sp_ulysses":
        heads_local = num_heads // max(tp_size, 1)
        if heads_local % seq_ring != 0:
            routed = "sp_allgather"
            reason = (f"sp_ulysses illegal on this mesh ({heads_local} heads per tp shard not divisible by seq "
                      f"ring {seq_ring}) — falling back to sp_allgather (AG-KV has no divisibility constraint)")
    if routed in UNPORTED_SEQ_BACKENDS:
        raise _unported(routed)
    return routed, reason


def _sp_windowed(q, k, v, window):
    """``sp_windowed`` on the active mesh's ``sp`` dim (``s2v_tpu/ops/attention.py:234-252``)."""
    mesh, axis = active_mesh(), active_axis("sp")
    if mesh is None or axis is None:
        raise ValueError("sp_windowed needs an active mesh with an 'sp' axis (S2VPipeline.set_mesh, or "
                         "s2v_torch.parallel.mesh_context)")
    if active_axis("dp") is not None or active_axis("tp") is not None:
        raise NotImplementedError("sp_windowed under a data or model mesh dim is not ported yet (ROADMAP A.9)")
    return banded_allgather_attention_trainable(q, k, v, mesh, axis, *window)


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


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def flash_attention_trainable(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Differentiable flash attention, ``[B, S, H, d]`` in and out.  Without
    autograd (no input needs a grad, or grad mode is off) it is one B1 call
    without lse, exactly what inference runs."""
    if _needs_grad(q, k, v):
        return _FlashAttention.apply(q, k, v)
    return flash_attention(q, k, v, softmax_mode=FLASH_SOFTMAX_MODE)


class _BandedAttention(torch.autograd.Function):
    """Banded windowed attention both ways (``s2v_tpu/ops/attention.py:386-427``):
    the forward is B4 with lse, saving q, k, v, o and lse; the backward is
    B5, which recomputes P from the lse."""

    @staticmethod
    def forward(ctx, q, k, v, global_len, tokens_per_frame, window_frames):
        o, lse = banded_flash_attention(q, k, v, global_len, tokens_per_frame, window_frames, return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.window = (global_len, tokens_per_frame, window_frames)
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, lse = ctx.saved_tensors
        return (*banded_flash_attention_bwd(q, k, v, o, lse, g.contiguous(), *ctx.window), None, None, None)


def banded_attention_trainable(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, global_len: int,
                               tokens_per_frame: int, window_frames: int) -> torch.Tensor:
    """Differentiable banded windowed attention, ``[B, S, H, d]`` in and out.
    Without autograd it is one B4 call without lse, what inference runs."""
    if _needs_grad(q, k, v):
        return _BandedAttention.apply(q, k, v, global_len, tokens_per_frame, window_frames)
    return banded_flash_attention(q, k, v, global_len, tokens_per_frame, window_frames)


class _Int8Attention(torch.autograd.Function):
    """B3 for inference only (``s2v_tpu/ops/attention.py:319-341``): it has
    no backward kernel, so differentiating it raises instead of training on
    a wrong gradient."""

    @staticmethod
    def forward(ctx, q, k, v):
        return flash_attention_qk_int8(q, k, v)

    @staticmethod
    def backward(ctx, g):
        raise NotImplementedError(
            "the int8-QK attention backend ('flash_int8') is inference-only (no backward kernel); "
            "train with 'flash' or 'windowed'")


def int8_attention_inference_only(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """int8-QK attention, ``[B, S, H, d]`` in and out.  Without autograd it
    is one B3 call."""
    if _needs_grad(q, k, v):
        return _Int8Attention.apply(q, k, v)
    return flash_attention_qk_int8(q, k, v)


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
    window: Optional[Tuple[int, int, int]] = None,  # (global_len, tokens_per_frame, w)
) -> torch.Tensor:
    """Full-sequence self attention: fused qkv, fp32-statistics qk-LayerNorm,
    segmented RoPE (``[S, d/2]`` tables, or None), attention, output linear.
    A windowed backend needs ``window``."""
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
    elif backend == "flash_int8":
        out = int8_attention_inference_only(q, k, v)
    elif backend in WINDOWED_BACKENDS:
        if window is None:
            raise ValueError(f"attention backend {backend!r} needs window=(global_len, tokens_per_frame, w)")
        if backend == "windowed":
            out = banded_attention_trainable(q, k, v, *window)
        elif backend == "sp_windowed":
            out = _sp_windowed(q, k, v, window)
        else:
            attn_fn = flash_attention_trainable if backend == "windowed_gather" else flash_attention_reference
            out = windowed_attention(q, k, v, *window, attention_fn=attn_fn)
    else:
        raise ValueError(f"unresolved attention backend {backend!r}")
    if fp16_in:
        out = out.to(torch.float16)
    return dense(params["to_out"], out.reshape(b, s, d))
