"""Sequence-parallel banded windowed attention, ``sp_windowed`` (counterpart
of ``s2v_tpu/parallel/sp_attention.py::banded_allgather_attention`` :202 and
``::banded_allgather_attention_trainable`` :327).

The video frames are sharded over the ``seq`` dim of a
``torch.distributed.device_mesh.DeviceMesh``; K/V are all-gathered and each
rank runs kernel B6 (``banded_flash_attention_local``) on its shard at its
global frame offset ``rank · F_loc``, so windows clamp to the global frame
range and shard-edge frames attend across the shard boundary exactly as the
single-card kernel B4 does.  The small ``[text | ref]`` global segment is
computed replicated, through B1 in the online mode.  The frame count is
padded to a ring multiple; the dummy frames' rows are dropped.

Contract on the port's replicated model: outside attention every rank holds
the whole ``[B, S, ...]`` activations (the port has no GSPMD), so the wrapper
takes and returns the full ``[B, S, H, d]`` on every rank.  Each rank takes
its frame shard of the queries and its row shard of K/V out of the full
tensors, all-gathers K/V and, after B6, the shards' outputs (and lse).  The
backward (``:369-443``) runs B7 for the local queries and B2 for the global
queries (their dk/dv scaled by ``1/P``, since every rank computes them), sums
the full-extent dk/dv partials over the ranks with one ``all_reduce`` (JAX's
``psum_scatter`` leaves each rank its row shard; here every rank needs the
whole sum) and all-gathers the dq shards, so every rank holds the whole
gradient of its replicated input.

At world size 1 the path is B6 at offset 0 over every frame, B1 for the
global queries and collectives of one rank: B4's result by another route.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from s2v_torch.kernels.banded_attention import BandGeometry, band_geometry, banded_flash_attention_local, ring_shards
from s2v_torch.kernels.banded_attention_bwd import banded_flash_attention_local_bwd
from s2v_torch.kernels.flash_attention import flash_attention
from s2v_torch.kernels.flash_attention_bwd import flash_attention_bwd


def _ring(mesh, axis_name: str):
    """(process group, ring size, this rank's index) of the mesh dim."""
    group = mesh.get_group(axis_name)
    return group, dist.get_world_size(group), dist.get_rank(group)


def _all_gather(x: torch.Tensor, dim: int, group, ring: int) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` (a strided view of one
    buffer gathered along its leading dim)."""
    xt = x.movedim(dim, 0).contiguous()
    buf = torch.empty((ring * xt.shape[0], *xt.shape[1:]), dtype=x.dtype, device=x.device)
    dist.all_gather(list(buf.chunk(ring)), xt, group=group)
    return buf.movedim(0, dim)


def _rows(x: torch.Tensor, lo: int, hi: int, end: int, dim: int = 1) -> torch.Tensor:
    """Rows ``[lo, hi)`` of ``x`` along ``dim``, zero past ``end`` (ring padding)."""
    piece = x.narrow(dim, min(lo, end), max(0, min(hi, end) - lo))
    pad = (hi - lo) - piece.shape[dim]
    if pad == 0:
        return piece
    widths = [0, 0] * (x.dim() - 1 - dim) + [0, pad]
    return F.pad(piece, widths)


def _gather_kv(x: torch.Tensor, group, ring: int, rank: int) -> torch.Tensor:
    """This rank's row shard of the full K (or V), padded to a ring multiple,
    all-gathered back into the full ``[B, S, H, d]`` (``:254-261``)."""
    s = x.shape[1]
    s_loc = -(-s // ring)
    return _all_gather(_rows(x, rank * s_loc, (rank + 1) * s_loc, s), 1, group, ring)[:, :s]


def _full_attn_with_lse(qg, k_full, v_full, scale):
    """Exact attention with the per-row lse for the global query segment
    (``:185``): B1 in the online mode, its plain version on CPU tensors."""
    return flash_attention(qg, k_full, v_full, scale=scale, return_lse=True, softmax_mode="online")


def _full_attn_bwd(qg, k_full, v_full, og, lseg, gg, scale):
    """Backward of the global query segment (``:310``): B2, its plain
    version on CPU tensors."""
    return flash_attention_bwd(qg, k_full, v_full, og, lseg.contiguous(), gg, scale)


def _rank_shard(s: int, global_len: int, tokens_per_frame: int, window_frames: int, ring: int,
                rank: int) -> BandGeometry:
    """This rank's frame shard of a ``[B, S, ...]`` call (frames padded to a
    ring multiple, ``:248-249``)."""
    geo = band_geometry(s, global_len, tokens_per_frame, window_frames)
    if ring > geo.n_frames:
        # B6/B7 take the shards of rings of at most F ranks (BandGeometry.shard)
        raise ValueError(f"a seq ring of {ring} ranks needs at least {ring} latent frames; the clip has "
                         f"{geo.n_frames}")
    _, f_loc = ring_shards(geo.n_frames, ring)
    return geo.shard(rank * f_loc, f_loc)


def shard_rows(x: torch.Tensor, shard: BandGeometry, dim: int = 1) -> torch.Tensor:
    """A shard's video rows of ``x`` (``[text | ref | video]`` along ``dim``):
    its frames' tokens, zero past the clip (ring-padding dummy frames)."""
    tpf = shard.tokens_per_frame
    vid_rows = shard.n_frames * tpf
    lo = shard.frame_offset * tpf
    return _rows(x.narrow(dim, shard.global_len, vid_rows), lo, lo + shard.local_frames * tpf, vid_rows, dim)


def banded_allgather_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mesh,
    axis_name: str,
    global_len: int,
    tokens_per_frame: int,
    window_frames: int,
    scale: Optional[float] = None,
    return_lse: bool = False,
):
    """Sequence-parallel banded windowed attention.  q/k/v ``[B, S, H, d]``,
    whole on every rank of ``mesh``'s ``axis_name`` dim; returns the whole
    ``[B, S, H, d]`` on every rank (and, with ``return_lse``, the fp32 lse
    ``[B, H, S]``, the residual of :func:`banded_allgather_attention_trainable`)."""
    b, s, h, d = q.shape
    group, ring, rank = _ring(mesh, axis_name)
    sh = _rank_shard(s, global_len, tokens_per_frame, window_frames, ring, rank)
    vid_rows = sh.n_frames * tokens_per_frame
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    k_full, v_full = _gather_kv(k, group, ring, rank), _gather_kv(v, group, ring, rank)
    local = banded_flash_attention_local(shard_rows(q, sh), k_full, v_full, global_len, tokens_per_frame,
                                         window_frames, sh.frame_offset, sh.n_frames, scale=scale,
                                         return_lse=return_lse)
    qg = q[:, :global_len]
    if return_lse:
        o_loc, lse_loc = local
        o_g, lse_g = _full_attn_with_lse(qg, k_full, v_full, scale)
    else:
        o_loc = local
        # the global queries, replicated: B1 online, as B4's wrapper runs them
        o_g = flash_attention(qg, k_full, v_full, scale=scale, softmax_mode="online")
    o = torch.cat([o_g, _all_gather(o_loc, 1, group, ring)[:, :vid_rows]], dim=1)
    if not return_lse:
        return o
    lse = torch.cat([lse_g, _all_gather(lse_loc, 2, group, ring)[..., :vid_rows]], dim=-1)
    return o, lse


class _BandedAllgatherAttention(torch.autograd.Function):
    """``sp_windowed`` both ways: the forward saves q, k, v, o and lse; the
    backward is B7 + B2 per rank, an all_reduce of dk/dv and an all_gather
    of the dq shards (``:359-443``)."""

    @staticmethod
    def forward(ctx, q, k, v, mesh, axis_name, global_len, tokens_per_frame, window_frames):
        o, lse = banded_allgather_attention(q, k, v, mesh, axis_name, global_len, tokens_per_frame, window_frames,
                                            return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (mesh, axis_name, global_len, tokens_per_frame, window_frames)
        return o

    @staticmethod
    def backward(ctx, gr):
        q, k, v, o, lse = ctx.saved_tensors
        mesh, axis_name, g, tpf, w = ctx.args
        dq, dk, dv = banded_allgather_attention_bwd(q, k, v, o, lse, gr, mesh, axis_name, g, tpf, w)
        return dq, dk, dv, None, None, None, None, None


def banded_allgather_attention_bwd(q, k, v, o, lse, gr, mesh, axis_name: str, global_len: int,
                                   tokens_per_frame: int, window_frames: int
                                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of :func:`banded_allgather_attention`, each the whole
    ``[B, S, H, d]`` on every rank; ``lse`` is its ``[B, H, S]`` residual and
    ``gr`` = dL/do, both whole."""
    b, s, h, d = q.shape
    group, ring, rank = _ring(mesh, axis_name)
    sh = _rank_shard(s, global_len, tokens_per_frame, window_frames, ring, rank)
    scale = 1.0 / math.sqrt(d)
    gr = gr.to(q.dtype).contiguous()
    k_full, v_full = _gather_kv(k, group, ring, rank), _gather_kv(v, group, ring, rank)
    # dummy frames: zero q and dO rows and lse 0, as JAX pads them (:394-397);
    # B7 leaves them out of every sum whatever they hold
    dq_loc, dk, dv = banded_flash_attention_local_bwd(
        shard_rows(q, sh), k_full, v_full, shard_rows(o, sh), shard_rows(lse, sh, dim=2).contiguous(),
        shard_rows(gr, sh), global_len, tokens_per_frame, window_frames, sh.frame_offset, sh.n_frames, scale)
    g = global_len
    dq_g, dk_g, dv_g = _full_attn_bwd(q[:, :g], k_full, v_full, o[:, :g], lse[..., :g], gr[:, :g], scale)
    # every rank computed the global queries' part: 1/P of it from each
    inv = 1.0 / ring
    dk = dk + dk_g * inv
    dv = dv + dv_g * inv
    dist.all_reduce(dk, group=group)
    dist.all_reduce(dv, group=group)
    dq = torch.cat([dq_g, _all_gather(dq_loc, 1, group, ring)[:, :sh.n_frames * tokens_per_frame]], dim=1)
    return dq, dk, dv


def banded_allgather_attention_trainable(q, k, v, mesh, axis_name: str, global_len: int, tokens_per_frame: int,
                                         window_frames: int) -> torch.Tensor:
    """Differentiable :func:`banded_allgather_attention` (B6/B1 forward,
    B7/B2 backward).  Without autograd (no input needs a grad, or grad mode
    is off) it is the inference call, without lse."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _BandedAllgatherAttention.apply(q, k, v, mesh, axis_name, global_len, tokens_per_frame,
                                               window_frames)
    return banded_allgather_attention(q, k, v, mesh, axis_name, global_len, tokens_per_frame, window_frames)
