"""The context-parallel VAE over a ``seq`` ring (counterpart of
``s2v_tpu/parallel/vae_temporal.py``: ``sharded_vae_decode`` :54,
``sharded_vae_decode_canonical`` :61, ``canonical_cp_chunks`` :129,
``sharded_vae_encode`` :139).

Each rank decodes (or encodes) one chunk of latent frames at once; every
causal conv takes its ``kt - 1``-frame cache from rank - 1 (a send/recv per
conv, ``ops/causal_conv3d.py::temporal_halo``), rank 0 starting the stream,
and the frames are all-gathered at the end, so every rank returns the whole
clip.  A chunk decodes as the streaming decode's chunk of the same frames
does, so the result is the streaming decode's with that schedule: with
uniform chunks (:func:`sharded_vae_decode`), or with the reference's own
schedule (:func:`sharded_vae_decode_canonical`), whose odd first chunk rank
0 decodes first and whose conv caches seed rank 0's halo.  Inputs are whole
on every rank, channels-last as ``models/vae.py``'s.  The spatial CP decode
of tiled frames is ``vae_spatial.py``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from s2v_torch.config import VAEConfig
from s2v_torch.models.vae import decoder_forward, encoder_forward
from s2v_torch.ops.causal_conv3d import temporal_halo
from s2v_torch.parallel.context import all_gather_rows


def _ring(mesh, axis_name: str):
    group = mesh.get_group(axis_name)
    return group, dist.get_world_size(group), dist.get_rank(group)


def _halo(group, rank: int, n_ranks: int):
    """The halo exchange of ranks 0 .. n_ranks - 1 of ``group``: each sends
    its input's last ``kt - 1`` frames to the next and pads with the
    previous rank's; rank 0 pads with the cache it was given, or with its
    first frame repeated (the stream's start)."""

    def exchange(x: torch.Tensor, kt: int, cache: Optional[torch.Tensor]) -> torch.Tensor:
        tail = x[:, :, -(kt - 1):].contiguous()
        recv = torch.empty_like(tail)
        ops = []
        if rank + 1 < n_ranks:
            ops.append(dist.P2POp(dist.isend, tail, dist.get_global_rank(group, rank + 1), group))
        if rank > 0:
            ops.append(dist.P2POp(dist.irecv, recv, dist.get_global_rank(group, rank - 1), group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        if rank > 0:
            return recv
        if cache is not None:
            return cache
        return x[:, :, :1].expand(-1, -1, kt - 1, -1, -1)

    return exchange


def _sharded(forward, params, cfg: VAEConfig, x, mesh, axis_name: str):
    """``forward`` over uniform chunks of the frames of ``x`` (channels-last,
    whole on every rank), one per rank."""
    group, ring, rank = _ring(mesh, axis_name)
    t = x.shape[1]
    if t % ring:
        raise ValueError(f"temporal sharding needs frames ({t}) divisible by the ring size ({ring}); pad or use "
                         f"the streaming path")
    n = t // ring
    xc = x[:, rank * n:(rank + 1) * n].permute(0, 4, 1, 2, 3)
    with temporal_halo(_halo(group, rank, ring)):
        y, _ = forward(params, cfg, xc, None)
    return all_gather_rows(y, group, ring, dim=2).permute(0, 2, 3, 4, 1)


def sharded_vae_decode(params, cfg: VAEConfig, z, mesh, axis_name: str = "seq"):
    """Latents ``[B, T, h, w, C]`` (T divisible by the ring) -> pixels,
    decoded context-parallel: the streaming decode with chunks of T / ring."""
    return _sharded(decoder_forward, params["decoder"], cfg, z, mesh, axis_name)


def sharded_vae_encode(params, cfg: VAEConfig, x, mesh, axis_name: str = "seq"):
    """Pixels ``[B, T, H, W, 3]`` (T divisible by the ring) -> posterior
    moments, encoded context-parallel."""
    return _sharded(encoder_forward, params["encoder"], cfg, x, mesh, axis_name)


def canonical_cp_chunks(cfg: VAEConfig, num_latent_frames: int) -> int:
    """The uniform chunks that follow the canonical schedule's first one:
    the ranks :func:`sharded_vae_decode_canonical` needs."""
    fb = cfg.num_latent_frames_batch_size
    t = num_latent_frames
    first = fb + t % fb if t > fb else t
    return max((t - first) // fb, 0)


def _decoded_frames(t: int) -> int:
    """Frames the decoder makes of a chunk of ``t`` latent frames (two
    temporal 2x upsamplings, an odd chunk keeping its first frame single)."""
    for _ in range(2):
        t = t if t <= 1 else (2 * t - 1 if t % 2 else 2 * t)
    return t


def sharded_vae_decode_canonical(params, cfg: VAEConfig, z, mesh, axis_name: str = "seq"):
    """The context-parallel decode of the reference's chunk schedule (the
    remainder folded into the first chunk), equal to the streaming decode
    for any frame count: rank 0 decodes the odd first chunk, then ranks 0 ..
    n - 1 decode the n uniform chunks at once, rank 0 seeded with the first
    chunk's conv caches; ranks past n idle.  Raises when the ring has fewer
    than n ranks."""
    dec = params["decoder"]
    group, ring, rank = _ring(mesh, axis_name)
    fb = cfg.num_latent_frames_batch_size
    t = z.shape[1]
    n = canonical_cp_chunks(cfg, t)
    if n <= 0:
        y, _ = decoder_forward(dec, cfg, z.permute(0, 4, 1, 2, 3), None)
        return y.permute(0, 2, 3, 4, 1)
    if n > ring:
        raise ValueError(f"canonical CP decode needs ring >= {n} chunks (have {ring})")
    first = t - n * fb
    zc = z.permute(0, 4, 1, 2, 3)
    cache = y0 = None
    if rank == 0:
        y0, cache = decoder_forward(dec, cfg, zc[:, :, :first], None)
    if rank < n:
        lo = first + rank * fb
        with temporal_halo(_halo(group, rank, n)):
            y, _ = decoder_forward(dec, cfg, zc[:, :, lo:lo + fb], cache)
    else:
        b, _, _, h, w = zc.shape
        sc = cfg.spatial_compression_ratio
        y = zc.new_zeros((b, cfg.out_channels, _decoded_frames(fb), h * sc, w * sc))
    if y0 is None:
        y0 = y.new_empty((y.shape[0], y.shape[1], _decoded_frames(first), *y.shape[3:]))
    dist.broadcast(y0, dist.get_global_rank(group, 0), group=group)
    rest = all_gather_rows(y, group, ring, dim=2)[:, :, :n * y.shape[2]]
    return torch.cat([y0, rest], dim=2).permute(0, 2, 3, 4, 1)
