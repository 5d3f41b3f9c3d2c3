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
  * ``chunked`` — :func:`chunked_attention`: exact attention blocked over
    queries in PyTorch ops, each block under ``torch.utils.checkpoint``, so
    its backward keeps one block's fp32 probabilities at a time (JAX
    ``chunked``, likewise no kernel).
  * ``flash_int8`` — :func:`int8_attention_inference_only`: kernel B3
    (``s2v_torch.kernels.int8_attention``), per-tensor int8 q·kᵀ, for int8
    serving (JAX ``pallas_int8``); inference only, its backward raises.
  * the windowed family (opt-in, approximate; ``window=(global_len,
    tokens_per_frame, w)``, see ``s2v_torch/ops/windowed_attention.py``):
    ``windowed`` — :func:`banded_attention_trainable`, kernel B4 forward and
    B5 backward (``s2v_torch.kernels.banded_attention``/``_bwd``);
    ``windowed_gather`` — the gather path on B1 (and B2 under autograd);
    ``windowed_plain`` — the gather path on the plain fp32 attention, the
    counterpart of JAX ``windowed_xla``.
  * the sequence-parallel backends (:data:`SEQ_BACKENDS`, over the ``seq``
    dim of the active mesh, ``s2v_torch/parallel/``): ``sp_allgather`` (K/V
    all-gathered, B1 forward and B2 backward), ``sp_int8`` (the same around
    B3, inference only), ``sp_ulysses`` (all-to-all from frames to heads
    around B1/B2), ``ring`` (K/V passed rank to rank, B1 per hop, an fp32
    ring pass backward) and the windowed ``sp_windowed`` (B6 and B1
    forward, B7 and B2 backward).  They take the rows of this rank's frame
    shard (``transformer_forward`` makes it); without a mesh context they
    raise.  On a ring above 1 the single-card backends of PyTorch ops
    (:data:`GATHERED_BACKENDS`: ``plain``, ``chunked``, ``windowed_plain``,
    which JAX's GSPMD partitions) run on the whole rows gathered from the
    ranks, each rank keeping its rows of the output; their attention is
    not split.

:func:`route_seq_backend` turns a single-card backend into its
sequence-parallel form on a ``seq`` ring above 1, as JAX's does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.utils.checkpoint

from s2v_torch.kernels.banded_attention import banded_flash_attention
from s2v_torch.kernels.banded_attention_bwd import banded_flash_attention_bwd
from s2v_torch.kernels.flash_attention import flash_attention, flash_attention_reference
from s2v_torch.kernels.flash_attention_bwd import flash_attention_bwd
from s2v_torch.kernels.int8_attention import flash_attention_qk_int8
from s2v_torch.kernels.qk_norm_rope import qk_norm_rope
from s2v_torch.ops.quant import dense
from s2v_torch.ops.windowed_attention import windowed_attention
from s2v_torch.parallel.context import FrameShard, seq_group
from s2v_torch.parallel.ring_attention import ring_attention_trainable
from s2v_torch.parallel.sp_attention import (
    allgather_kv_attention_trainable,
    banded_allgather_attention_trainable,
    gather_rows,
    int8_allgather_attention,
    ulysses_attention_trainable,
)
from s2v_torch.utils.device import needs_grad
from s2v_torch.utils.logging import phase

# backends that take the sliding temporal window (entry points configure its width)
WINDOWED_BACKENDS = ("windowed", "windowed_gather", "windowed_plain", "sp_windowed")
# backends that run on the frame shards of a seq ring
SEQ_BACKENDS = ("ring", "sp_allgather", "sp_int8", "sp_ulysses", "sp_windowed")
# single-card backends that also run on a seq ring above 1, on the gathered rows
GATHERED_BACKENDS = ("plain", "chunked", "windowed_plain")
ATTENTION_BACKENDS = ("auto", "flash", "plain", "chunked", "flash_int8", "ring", "sp_allgather", "sp_int8",
                      "sp_ulysses") + WINDOWED_BACKENDS
FLASH_SOFTMAX_MODE = "bounded"
# fp16 (2b) q/k/v: on the card every kernel backend takes it as it is (B1-B7
# have fp16 forms); on the CPU the backends on B1/B2 do too (their plain
# versions compute in fp32), and every other case upcasts as the JAX package
# does.  fp32 q/k/v go to every backend as they are: on the card B1-B7
# launch their fp32 forms (3xTF32 products; B3's logits exact int32)
FP16_KERNEL_BACKENDS = ("flash", "windowed_gather")
CARD_FP16_BACKENDS = ("flash_int8", "windowed") + SEQ_BACKENDS


def resolve_attention_backend(backend: str, device: torch.device) -> str:
    """``auto`` -> ``flash`` on CUDA, ``plain`` on the CPU."""
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

    ``flash`` -> ``sp_allgather``, ``flash_int8`` -> ``sp_int8``,
    ``windowed`` -> ``sp_windowed``, an ``sp_ulysses`` whose heads the ring
    does not divide -> ``sp_allgather``; ``windowed_gather`` has no SP form
    and raises ``ValueError``.  A ring of 1 leaves every backend as it is."""
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
                      f"ring {seq_ring}) — falling back to sp_allgather (AG-KV has no divisibility constraint; "
                      f"docs/SCALING.md)")
    return routed, reason


def _seq_attention(backend: str, q, k, v, shard: Optional[FrameShard], window):
    """A sequence-parallel backend on this rank's rows
    (``s2v_tpu/ops/attention.py:234-300``)."""
    seq_group(backend)  # raises without a mesh context
    if shard is None:
        raise ValueError(f"{backend} runs on the frame shards transformer_forward makes; call it through "
                         f"transformer_forward")
    g = q.shape[1] - shard.local_rows
    if backend == "sp_windowed":
        if window is None:
            raise ValueError("sp_windowed needs window=(global_len, tokens_per_frame, w)")
        return banded_allgather_attention_trainable(q, k, v, shard, g, window[2])
    if backend == "sp_allgather":
        return allgather_kv_attention_trainable(q, k, v, shard, g, FLASH_SOFTMAX_MODE)
    if backend == "sp_int8":
        return int8_allgather_attention(q, k, v, shard, g)
    if backend == "sp_ulysses":
        return ulysses_attention_trainable(q, k, v, shard, g, FLASH_SOFTMAX_MODE)
    return ring_attention_trainable(q, k, v, shard, g, FLASH_SOFTMAX_MODE)


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
    if needs_grad(q, k, v):
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
    if needs_grad(q, k, v):
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
    if needs_grad(q, k, v):
        return _Int8Attention.apply(q, k, v)
    return flash_attention_qk_int8(q, k, v)


def _attention_block(q_blk: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    logits = torch.einsum("bqhd,bkhd->bhqk", q_blk.float(), k.float())
    # scaled in place: the product's backward needs its inputs, not its output
    w = torch.softmax(logits.mul_(scale), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", w.to(v.dtype), v)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, block_q: int = 1024) -> torch.Tensor:
    """Exact attention over query blocks of ``block_q`` rows
    (``s2v_tpu/ops/attention.py:430-461``): fp32 logits and softmax, P cast
    to v's dtype for P·V; ``[B, S, H, d]`` in and out.  Under autograd each
    block runs in ``torch.utils.checkpoint``, so the backward recomputes one
    block's probabilities at a time instead of keeping all S² of them."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    grad = needs_grad(q, k, v)
    outs = []
    for i in range(0, q.shape[1], block_q):
        q_blk = q[:, i:i + block_q]
        if grad:
            outs.append(torch.utils.checkpoint.checkpoint(_attention_block, q_blk, k, v, scale, use_reentrant=False))
        else:
            outs.append(_attention_block(q_blk, k, v, scale))
    return torch.cat(outs, dim=1)


def _single_card_attention(backend: str, q, k, v, window):
    if backend == "flash":
        return flash_attention_trainable(q, k, v)
    if backend == "plain":
        return flash_attention_reference(q, k, v)
    if backend == "chunked":
        return chunked_attention(q, k, v)
    if backend == "flash_int8":
        return int8_attention_inference_only(q, k, v)
    if backend in WINDOWED_BACKENDS:
        if window is None:
            raise ValueError(f"attention backend {backend!r} needs window=(global_len, tokens_per_frame, w)")
        if backend == "windowed":
            return banded_attention_trainable(q, k, v, *window)
        attn_fn = flash_attention_trainable if backend == "windowed_gather" else flash_attention_reference
        return windowed_attention(q, k, v, *window, attention_fn=attn_fn)
    raise ValueError(f"unresolved attention backend {backend!r}")


def _on_gathered_rows(backend: str, q, k, v, shard: FrameShard, window):
    """A backend of :data:`GATHERED_BACKENDS` on a seq ring: every rank's
    video rows gathered (summed back to their owner in the backward), the
    single-card backend on the whole sequence, this rank's rows of its
    output."""
    if backend not in GATHERED_BACKENDS:
        raise ValueError(f"attention backend {backend!r} has no form on a seq ring of {shard.ring}; use one of "
                         f"{SEQ_BACKENDS + GATHERED_BACKENDS} (S2VPipeline routes flash to sp_allgather)")
    g = q.shape[1] - shard.local_rows
    out = _single_card_attention(backend, *(gather_rows(t, g, shard) for t in (q, k, v)), window)
    return torch.cat([out[:, :g], shard.take(out[:, g:])], dim=1)


def qkv_projections(params: dict, x: torch.Tensor, num_heads: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``[B, S, D]`` -> per-head q, k, v ``[B, S, H, d]`` through the fused
    ``qkv`` linear (weight ``[3D, D]``, rows q | k | v; under megatron TP
    this rank's ``H`` heads of each, ``[3D/tp, D]``)."""
    b, s, _ = x.shape
    q, k, v = dense(params["qkv"], x).chunk(3, dim=-1)
    shape = (b, s, num_heads, q.shape[-1] // num_heads)
    return q.reshape(shape), k.reshape(shape), v.reshape(shape)


def local_heads(num_heads: int, tp) -> int:
    """The heads one rank of the ``model`` dim computes; a dim that does not
    divide them raises."""
    if tp is None:
        return num_heads
    if num_heads % tp.size:
        raise ValueError(f"{num_heads} attention heads do not split over a model mesh dim of {tp.size} ranks")
    return num_heads // tp.size


def joint_attention(
    params: dict,
    x: torch.Tensor,
    num_heads: int,
    rope_cos: Optional[torch.Tensor] = None,
    rope_sin: Optional[torch.Tensor] = None,
    qk_norm_eps: float = 1e-6,
    backend: str = "plain",
    window: Optional[Tuple[int, int, int]] = None,  # (global_len, tokens_per_frame, w)
    shard: Optional[FrameShard] = None,
    tp=None,
) -> torch.Tensor:
    """Full-sequence self attention: fused qkv, fp32-statistics qk-LayerNorm,
    segmented RoPE (``[S, d/2]`` tables, or None; the two in one kernel on
    the card without autograd, ``kernels/qk_norm_rope.py``), attention,
    output linear.
    A windowed backend needs ``window``; a sequence-parallel one ``shard``,
    this rank's frames, ``x`` being its rows ``[text | ref | its frames]``.

    ``tp`` (the ``model`` dim, ``parallel/context.py::tensor_parallel``):
    megatron TP on this rank's ``num_heads / tp`` heads: the qkv
    column-parallel by heads, the per-head qk norms on the local heads
    (their gradients summed over ``model``), every backend on the local
    heads, ``to_out`` row-parallel with one all-reduce."""
    from s2v_torch.parallel.context import copy_to_model

    b, s, _ = x.shape
    heads = local_heads(num_heads, tp)
    norm_q, norm_k = params["norm_q"], params["norm_k"]
    if tp is not None:
        x = copy_to_model(x, tp)
        norm_q, norm_k = ({n: copy_to_model(w, tp) for n, w in p.items()} for p in (norm_q, norm_k))
    q, k, v = qkv_projections(params, x, heads)
    # fp16 storage: upcast once before attention and cast back after, as
    # JAX does for every backend (s2v_tpu/ops/attention.py:208-214), except
    # into the kernels, which take fp16 and return it (the same fp32
    # accumulation; P and dS rounded to fp16); fp32 is never cast
    fp16_in = q.dtype == torch.float16 and not (
        backend in FP16_KERNEL_BACKENDS or (q.is_cuda and backend in CARD_FP16_BACKENDS))
    with phase("s2v.qk_rope"):
        q, k = qk_norm_rope(q, k, norm_q, norm_k, qk_norm_eps, rope_cos, rope_sin)
        if fp16_in:
            q, k, v = (t.float() for t in (q, k, v))
    with phase("s2v.attention"):
        if backend in SEQ_BACKENDS:
            out = _seq_attention(backend, q, k, v, shard, window)
        elif shard is not None:
            out = _on_gathered_rows(backend, q, k, v, shard, window)
        else:
            out = _single_card_attention(backend, q, k, v, window)
        if fp16_in:
            out = out.to(torch.float16)
    return dense(params["to_out"], out.reshape(b, s, -1), row_parallel=tp)
