"""Sequence-parallel attention on the frame shards of a ``seq`` ring
(counterpart of ``s2v_tpu/parallel/sp_attention.py``): all-gather-KV
``sp_allgather`` (``allgather_kv_attention`` :59, around kernel B1, or B3 for
``sp_int8``), Ulysses ``sp_ulysses`` (``ulysses_attention`` :111) and the
banded ``sp_windowed`` (``banded_allgather_attention`` :202, kernels B6/B7).
Ring attention is ``ring_attention.py``.

Every wrapper takes this rank's rows ``[text | ref | its video frames]``
(``[B, G + F_loc·tpf, H, d]``, the frame layout of
:class:`s2v_torch.parallel.context.FrameShard`, dummy frames included) and
returns the attention output of the same rows.  The ``[text | ref]`` global
segment of ``G`` rows is whole on every rank.  The keys are ``[text | ref]``
and every rank's real video frames in order: the dummy frames' keys are
dropped.  JAX pads the joint sequence to a ring multiple and shards its rows
(``:88-93``); the padded rows and keys are exact no-ops in both layouts, so
the results agree to rounding, except ``sp_int8``'s per-tensor q scale, which
each rank takes over its own rows (ROADMAP C.27).

Backwards follow the gradient contract of ``parallel/context.py``: the
video keys' gradients are summed over the ring and each rank keeps its own
frames' (the transpose of the all-gather; gloo has no reduce_scatter, so an
all_reduce and a slice), the replicated text and ref keep their share.  At a
ring of 1 the collectives move nothing and each wrapper is its single-card
kernel on the same inputs.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from s2v_torch.kernels.banded_attention import banded_flash_attention_local
from s2v_torch.kernels.banded_attention_bwd import banded_flash_attention_local_bwd
from s2v_torch.kernels.flash_attention import flash_attention
from s2v_torch.kernels.flash_attention_bwd import flash_attention_bwd
from s2v_torch.kernels.int8_attention import flash_attention_qk_int8
from s2v_torch.parallel.context import FrameShard, all_gather_rows, sum_and_take
from s2v_torch.utils.device import needs_grad

# JAX's message for a differentiated int8 backend (s2v_tpu/ops/attention.py:319-330)
INT8_BACKWARD_MESSAGE = ("the int8-QK attention backends ('pallas_int8'/'sp_int8') are inference-only (no backward "
                         "kernels); train with 'pallas', 'sp_allgather', 'windowed', or 'chunked'")


def gather_kv(x: torch.Tensor, global_len: int, shard: FrameShard) -> torch.Tensor:
    """This rank's K (or V) rows -> ``[text | ref | the clip's video]``:
    the global rows as they are, every rank's video frames all-gathered,
    the dummy frames dropped."""
    video = all_gather_rows(x[:, global_len:], shard.group, shard.ring)[:, :shard.video_rows]
    return torch.cat([x[:, :global_len], video], dim=1)


def kv_grad_to_shard(dx: torch.Tensor, global_len: int, shard: FrameShard) -> torch.Tensor:
    """The transpose of :func:`gather_kv`: this rank's share of the
    gradient over every key -> the gradient of its own rows."""
    return torch.cat([dx[:, :global_len], sum_and_take(dx[:, global_len:], shard)], dim=1)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, global_len, shard):
        ctx.args = (global_len, shard)
        return gather_kv(x, global_len, shard)

    @staticmethod
    def backward(ctx, g):
        return kv_grad_to_shard(g, *ctx.args), None, None


def gather_rows(x: torch.Tensor, global_len: int, shard: FrameShard) -> torch.Tensor:
    """:func:`gather_kv` under autograd, :func:`kv_grad_to_shard` its backward."""
    return _GatherRows.apply(x, global_len, shard)


# ---------------------------------------------------------------------------
# sp_allgather / sp_int8
# ---------------------------------------------------------------------------

def allgather_kv_attention(q, k, v, shard: FrameShard, global_len: int, return_lse: bool = False,
                           softmax_mode: str = "bounded", int8: bool = False):
    """AG-KV attention of this rank's rows against every key: B1 (with its
    fp32 lse when ``return_lse``), or B3 with ``int8``."""
    kf, vf = gather_kv(k, global_len, shard), gather_kv(v, global_len, shard)
    if int8:
        return flash_attention_qk_int8(q, kf, vf)
    return flash_attention(q, kf, vf, return_lse=return_lse, softmax_mode=softmax_mode)


class _AllgatherKV(torch.autograd.Function):
    """``sp_allgather`` both ways: B1 with lse forward; B2 on the local rows
    backward, K/V gathered again (only the local rows are saved)."""

    @staticmethod
    def forward(ctx, q, k, v, shard, global_len, softmax_mode):
        o, lse = allgather_kv_attention(q, k, v, shard, global_len, True, softmax_mode)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (shard, global_len)
        return o

    @staticmethod
    def backward(ctx, go):
        q, k, v, o, lse = ctx.saved_tensors
        shard, g = ctx.args
        kf, vf = gather_kv(k, g, shard), gather_kv(v, g, shard)
        dq, dkf, dvf = flash_attention_bwd(q, kf, vf, o, lse, go.contiguous())
        return dq, kv_grad_to_shard(dkf, g, shard), kv_grad_to_shard(dvf, g, shard), None, None, None


class _Int8AllgatherKV(torch.autograd.Function):
    """``sp_int8`` under autograd: the forward, and a backward that raises."""

    @staticmethod
    def forward(ctx, q, k, v, shard, global_len):
        return allgather_kv_attention(q, k, v, shard, global_len, int8=True)

    @staticmethod
    def backward(ctx, go):
        raise NotImplementedError(INT8_BACKWARD_MESSAGE)


def allgather_kv_attention_trainable(q, k, v, shard: FrameShard, global_len: int,
                                     softmax_mode: str = "bounded") -> torch.Tensor:
    """Differentiable ``sp_allgather``; without autograd one B1 call without lse."""
    if needs_grad(q, k, v):
        return _AllgatherKV.apply(q, k, v, shard, global_len, softmax_mode)
    return allgather_kv_attention(q, k, v, shard, global_len, softmax_mode=softmax_mode)


def int8_allgather_attention(q, k, v, shard: FrameShard, global_len: int) -> torch.Tensor:
    """``sp_int8``: inference only, differentiating it raises JAX's message."""
    if needs_grad(q, k, v):
        return _Int8AllgatherKV.apply(q, k, v, shard, global_len)
    return allgather_kv_attention(q, k, v, shard, global_len, int8=True)


# ---------------------------------------------------------------------------
# sp_ulysses
# ---------------------------------------------------------------------------

def _heads(shard: FrameShard, num_heads: int) -> slice:
    if num_heads % shard.ring:
        raise ValueError(f"sp_ulysses needs heads divisible by the seq axis: {num_heads} heads vs ring {shard.ring}")
    h_loc = num_heads // shard.ring
    return slice(shard.rank * h_loc, (shard.rank + 1) * h_loc)


def _all_to_all(send: torch.Tensor, shard: FrameShard) -> torch.Tensor:
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=shard.group)
    return recv


def seq_to_heads(x: torch.Tensor, shard: FrameShard) -> torch.Tensor:
    """This rank's video rows of every head ``[B, F_loc·tpf, H, d]`` ->
    every real video row of this rank's heads ``[B, F·tpf, H/ring, d]``."""
    b, lv, h, d = x.shape
    r = shard.ring
    recv = _all_to_all(x.reshape(b, lv, r, h // r, d).permute(2, 0, 1, 3, 4).contiguous(), shard)
    return recv.permute(1, 0, 2, 3, 4).reshape(b, r * lv, h // r, d)[:, :shard.video_rows]


def heads_to_seq(y: torch.Tensor, shard: FrameShard) -> torch.Tensor:
    """The inverse of :func:`seq_to_heads` (zero on the dummy frames)."""
    b, rows, hl, d = y.shape
    r, lv = shard.ring, shard.local_rows
    y = F.pad(y, (0, 0, 0, 0, 0, r * lv - rows))
    recv = _all_to_all(y.reshape(b, r, lv, hl, d).permute(1, 0, 2, 3, 4).contiguous(), shard)
    return recv.permute(1, 2, 0, 3, 4).reshape(b, lv, r * hl, d)


def _ulysses_inputs(q, k, v, shard, global_len, heads):
    """q, k, v of this rank's heads over ``[text | ref | every real frame]``."""
    return tuple(torch.cat([t[:, :global_len, heads], seq_to_heads(t[:, global_len:], shard)], dim=1)
                 for t in (q, k, v))


def _ulysses_output(o, shard, global_len):
    """This rank's heads over every row -> every head over this rank's rows:
    the global rows all-gathered over heads, the video rows sent home."""
    o_g = all_gather_rows(o[:, :global_len], shard.group, shard.ring, dim=2)
    return torch.cat([o_g, heads_to_seq(o[:, global_len:], shard)], dim=1)


def ulysses_attention(q, k, v, shard: FrameShard, global_len: int, softmax_mode: str = "bounded") -> torch.Tensor:
    """Ulysses attention: an all-to-all from frame shards to head shards,
    B1 over every row for this rank's heads, and back."""
    heads = _heads(shard, q.shape[2])
    qh, kh, vh = _ulysses_inputs(q, k, v, shard, global_len, heads)
    return _ulysses_output(flash_attention(qh, kh, vh, softmax_mode=softmax_mode), shard, global_len)


class _Ulysses(torch.autograd.Function):
    """``sp_ulysses`` both ways; the all-to-alls are linear, so the backward
    is B2 between the reverse all-to-alls.  The global rows' output gradient
    is this rank's share: summed over the ring (the transpose of the
    all-gather over heads) before B2, and the global rows' input gradient
    stays on this rank's heads."""

    @staticmethod
    def forward(ctx, q, k, v, shard, global_len, softmax_mode):
        heads = _heads(shard, q.shape[2])
        qh, kh, vh = _ulysses_inputs(q, k, v, shard, global_len, heads)
        oh, lse = flash_attention(qh, kh, vh, return_lse=True, softmax_mode=softmax_mode)
        ctx.save_for_backward(qh, kh, vh, oh, lse)
        ctx.args = (shard, global_len, heads, q.shape)
        return _ulysses_output(oh, shard, global_len)

    @staticmethod
    def backward(ctx, go):
        qh, kh, vh, oh, lse = ctx.saved_tensors
        shard, g, heads, shape = ctx.args
        go_g = go[:, :g].contiguous()
        dist.all_reduce(go_g, group=shard.group)
        goh = torch.cat([go_g[:, :, heads], seq_to_heads(go[:, g:].contiguous(), shard)], dim=1)
        grads = flash_attention_bwd(qh, kh, vh, oh, lse, goh)
        out = []
        for dh in grads:
            d_g = dh.new_zeros((shape[0], g, *shape[2:]))
            d_g[:, :, heads] = dh[:, :g]
            out.append(torch.cat([d_g, heads_to_seq(dh[:, g:], shard)], dim=1))
        return (*out, None, None, None)


def ulysses_attention_trainable(q, k, v, shard: FrameShard, global_len: int,
                                softmax_mode: str = "bounded") -> torch.Tensor:
    """Differentiable ``sp_ulysses``; without autograd the inference call."""
    if needs_grad(q, k, v):
        return _Ulysses.apply(q, k, v, shard, global_len, softmax_mode)
    return ulysses_attention(q, k, v, shard, global_len, softmax_mode)


# ---------------------------------------------------------------------------
# sp_windowed
# ---------------------------------------------------------------------------

def banded_allgather_attention(q, k, v, shard: FrameShard, global_len: int, window_frames: int,
                               scale: Optional[float] = None, return_lse: bool = False):
    """Sequence-parallel banded windowed attention: K/V all-gathered, B6 for
    this rank's video rows at its global frame offset (windows clamp to the
    clip, shard-edge frames attend across the boundary as B4's do), and B1
    in the online mode for the replicated global rows.  Returns the rows'
    output (and the fp32 lse ``[B, H, rows]``)."""
    d = q.shape[-1]
    g, tpf = global_len, shard.tokens_per_frame
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    kf, vf = gather_kv(k, g, shard), gather_kv(v, g, shard)
    local = banded_flash_attention_local(q[:, g:], kf, vf, g, tpf, window_frames, shard.first_frame, shard.n_frames,
                                         scale=scale, return_lse=return_lse)
    glob = flash_attention(q[:, :g], kf, vf, scale=scale, return_lse=return_lse, softmax_mode="online")
    if not return_lse:
        return torch.cat([glob, local], dim=1)
    return torch.cat([glob[0], local[0]], dim=1), torch.cat([glob[1], local[1]], dim=-1)


class _BandedAllgatherAttention(torch.autograd.Function):
    """``sp_windowed`` both ways (``:359-443``): B7 for the video rows and
    B2 for the global rows, their key gradients summed and sent to the
    frames' owners."""

    @staticmethod
    def forward(ctx, q, k, v, shard, global_len, window_frames):
        o, lse = banded_allgather_attention(q, k, v, shard, global_len, window_frames, return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (shard, global_len, window_frames)
        return o

    @staticmethod
    def backward(ctx, go):
        q, k, v, o, lse = ctx.saved_tensors
        shard, g, w = ctx.args
        dq, dk, dv = banded_allgather_attention_bwd(q, k, v, o, lse, go, shard, g, w)
        return dq, dk, dv, None, None, None


def banded_allgather_attention_bwd(q, k, v, o, lse, go, shard: FrameShard, global_len: int, window_frames: int
                                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of this rank's rows; ``lse`` is the forward's residual
    and ``go`` this rank's share of dL/do."""
    g, tpf = global_len, shard.tokens_per_frame
    scale = 1.0 / math.sqrt(q.shape[-1])
    go = go.to(q.dtype).contiguous()
    kf, vf = gather_kv(k, g, shard), gather_kv(v, g, shard)
    # B7 leaves the dummy frames' rows out of every sum whatever they hold
    dq_loc, dkf, dvf = banded_flash_attention_local_bwd(
        q[:, g:], kf, vf, o[:, g:], lse[..., g:].contiguous(), go[:, g:], g, tpf, window_frames, shard.first_frame,
        shard.n_frames, scale)
    dq_g, dk_g, dv_g = flash_attention_bwd(q[:, :g], kf, vf, o[:, :g], lse[..., :g].contiguous(), go[:, :g], scale)
    dq = torch.cat([dq_g, dq_loc], dim=1)
    return dq, kv_grad_to_shard(dkf + dk_g, g, shard), kv_grad_to_shard(dvf + dv_g, g, shard)


def banded_allgather_attention_trainable(q, k, v, shard: FrameShard, global_len: int,
                                         window_frames: int) -> torch.Tensor:
    """Differentiable :func:`banded_allgather_attention` (B6/B1 forward,
    B7/B2 backward); without autograd the inference call, without lse."""
    if needs_grad(q, k, v):
        return _BandedAllgatherAttention.apply(q, k, v, shard, global_len, window_frames)
    return banded_allgather_attention(q, k, v, shard, global_len, window_frames)
