"""Ring attention on the frame shards of a ``seq`` ring (counterpart of
``s2v_tpu/parallel/ring_attention.py``: ``ring_attention`` :140,
``ring_attention_trainable`` :202).

Each rank holds its rows ``[text | ref | its video frames]`` (the layout of
``parallel/sp_attention.py``).  Hop 0 attends its queries to its own keys,
text and ref included; at hop i it attends them to the video frames of rank
``rank - i``, whose K/V shard came from rank - 1 and goes on to rank + 1
(``batch_isend_irecv``).  Each hop is one call of kernel B1 with its fp32
lse, the dummy frames' keys masked (``key_pad_mask``), and the hops merge in
fp32 by log-sum-exp reweighting (``:98-135``); a hop whose keys are all
dummy frames is skipped, since it adds nothing.  The backward is JAX's
second ring pass (``_ring_bwd_local`` :230-268) in fp32 PyTorch ops: K/V and
their gradient accumulators travel the ring together and come home after the
last hop; the text and ref keys' gradients stay on the rank (its share, the
contract of ``parallel/context.py``).  JAX's backward is no Pallas kernel,
so it has none here.  The per-hop probabilities are computed
``BWD_CHUNK`` query rows at a time.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from s2v_torch.kernels.flash_attention import NEG_INF, flash_attention
from s2v_torch.parallel.context import FrameShard
from s2v_torch.utils.device import needs_grad

# query rows per block of the backward's fp32 probabilities: 512 x 19,126
# keys x 48 heads is 1.9 GB per tensor
BWD_CHUNK = 512


def _pass_on(tensors, shard: FrameShard):
    """Send the tensors to rank + 1 and receive rank - 1's in their place."""
    r, n = shard.rank, shard.ring
    nxt, prv = dist.get_global_rank(shard.group, (r + 1) % n), dist.get_global_rank(shard.group, (r - 1) % n)
    recv = [torch.empty_like(t) for t in tensors]
    ops = [dist.P2POp(dist.isend, t, nxt, shard.group) for t in tensors]
    ops += [dist.P2POp(dist.irecv, t, prv, shard.group) for t in recv]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv


def _hops(k, v, shard: FrameShard, global_len: int):
    """(source rank, K, V, key pad mask) of each hop: the rank's own keys,
    then every other rank's video frames; the K/V travel the ring."""
    yield shard.rank, k, v, shard.dummy_key_mask(shard.rank, global_len, k.device)
    kv = [k[:, global_len:].contiguous(), v[:, global_len:].contiguous()]
    for i in range(1, shard.ring):
        kv = _pass_on(kv, shard)
        src = (shard.rank - i) % shard.ring
        yield src, kv[0], kv[1], shard.dummy_key_mask(src, 0, k.device)


def ring_attention(q, k, v, shard: FrameShard, global_len: int, return_lse: bool = False,
                   softmax_mode: str = "bounded"):
    """Exact attention of this rank's rows over the ring; returns the
    output in q's dtype (and the fp32 lse ``[B, H, rows]``)."""
    b, s, h, d = q.shape
    o_acc = torch.zeros((b, s, h, d), dtype=torch.float32, device=q.device)
    lse_acc = torch.full((b, h, s), NEG_INF, dtype=torch.float32, device=q.device)
    for src, k_i, v_i, mask in _hops(k, v, shard, global_len):
        if src != shard.rank and shard.real_frames_of(src) == 0:
            continue
        o_i, lse_i = flash_attention(q, k_i, v_i, return_lse=True, key_pad_mask=mask, softmax_mode=softmax_mode)
        lse_new = torch.logaddexp(lse_acc, lse_i)
        w_acc = torch.exp(lse_acc - lse_new).transpose(1, 2)[..., None]
        w_i = torch.exp(lse_i - lse_new).transpose(1, 2)[..., None]
        o_acc = o_acc * w_acc + o_i.float() * w_i
        lse_acc = lse_new
    o = o_acc.to(q.dtype)
    return (o, lse_acc) if return_lse else o


def _hop_grads(qf, gf, lse, d_row, k_i, v_i, mask, scale, dq):
    """One hop of the backward: adds to ``dq`` and returns this hop's
    (dk, dv) in fp32, the probabilities ``BWD_CHUNK`` query rows at a time."""
    kf, vf = k_i.float(), v_i.float()
    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    for c0 in range(0, qf.shape[1], BWD_CHUNK):
        qc, gc = qf[:, c0:c0 + BWD_CHUNK], gf[:, c0:c0 + BWD_CHUNK]
        s = torch.einsum("bqhd,bkhd->bhqk", qc, kf) * scale
        if mask is not None:
            s = s.masked_fill(mask, NEG_INF)
        p = torch.exp(s - lse[:, :, c0:c0 + BWD_CHUNK, None])  # normalised over the whole ring
        dp = torch.einsum("bqhd,bkhd->bhqk", gc, vf)
        ds = p * (dp - d_row[:, :, c0:c0 + BWD_CHUNK, None])
        dq[:, c0:c0 + BWD_CHUNK] += torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
        dk += torch.einsum("bhqk,bqhd->bkhd", ds, qc) * scale
        dv += torch.einsum("bhqk,bqhd->bkhd", p, gc)
    return dk, dv


def ring_attention_bwd(q, k, v, o, lse, go, shard: FrameShard, global_len: int):
    """(dq, dk, dv) of this rank's rows: the second ring pass."""
    g = global_len
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf, gf = q.float(), go.float()
    d_row = (gf * o.float()).sum(-1).transpose(1, 2)  # [B, H, rows]
    dq = torch.zeros_like(qf)
    # hop 0: the own keys; the text and ref part stays here
    dk0, dv0 = _hop_grads(qf, gf, lse, d_row, k, v, shard.dummy_key_mask(shard.rank, g, k.device), scale, dq)
    acc = [k[:, g:].contiguous(), v[:, g:].contiguous(), dk0[:, g:].contiguous(), dv0[:, g:].contiguous()]
    for i in range(1, shard.ring):
        acc = _pass_on(acc, shard)
        src = (shard.rank - i) % shard.ring
        if shard.real_frames_of(src) == 0:
            continue
        dk_i, dv_i = _hop_grads(qf, gf, lse, d_row, acc[0], acc[1], shard.dummy_key_mask(src, 0, k.device), scale, dq)
        acc[2] += dk_i
        acc[3] += dv_i
    if shard.ring > 1:
        acc = _pass_on(acc, shard)  # each shard's accumulators come home
    dk = torch.cat([dk0[:, :g], acc[2]], dim=1)
    dv = torch.cat([dv0[:, :g], acc[3]], dim=1)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, shard, global_len, softmax_mode):
        o, lse = ring_attention(q, k, v, shard, global_len, True, softmax_mode)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (shard, global_len)
        return o

    @staticmethod
    def backward(ctx, go):
        q, k, v, o, lse = ctx.saved_tensors
        return (*ring_attention_bwd(q, k, v, o, lse, go, *ctx.args), None, None, None)


def ring_attention_trainable(q, k, v, shard: FrameShard, global_len: int,
                             softmax_mode: str = "bounded") -> torch.Tensor:
    """Differentiable ring attention (B1 per hop forward, the fp32 ring pass
    backward); without autograd the inference call."""
    if needs_grad(q, k, v):
        return _RingAttention.apply(q, k, v, shard, global_len, softmax_mode)
    return ring_attention(q, k, v, shard, global_len, softmax_mode=softmax_mode)
