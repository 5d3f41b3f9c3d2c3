"""Logical-axis mesh context and the frame shards of a ``seq`` ring
(counterpart of ``s2v_tpu/parallel/context.py``).

Model code asks :func:`active_mesh` and :func:`active_axis` for the mesh and
the name of the mesh dimension a *logical* axis (``"dp"``/``"sp"``/``"tp"``)
is mapped to; outside a :func:`mesh_context` both are None, so single-card
paths run unchanged.  The mesh is a
``torch.distributed.device_mesh.DeviceMesh`` whose dims carry names, as a
``jax.sharding.Mesh``'s axes do; its process group must already be
initialised.  Only the ``"sp"`` -> ``"seq"`` mapping is used.

``constrain`` (``with_sharding_constraint`` for GSPMD) has no PyTorch
counterpart; the port shards by hand instead.  Under a ``seq`` ring above 1
the DiT's video stream is split by latent frames (:class:`FrameShard`): rank
r holds frames ``r·F_loc .. r·F_loc + F_loc - 1`` with ``F_loc = ceil(F /
ring)``, the frames past F being zero *dummy* frames (the ring padding of
``BandGeometry.shard``/``ring_shards``).  The text and ref streams stay whole
on every rank: each rank computes them alike (replicas).

Gradient contract of the sharded model: each rank's backward carries its own
share of the loss.  The video rows of the DiT's output are gathered by
:func:`gather_video`, whose backward keeps this rank's rows of a gradient
that every rank holds alike, so each video row's loss is counted on one rank.
A replicated tensor's gradient on a rank is then that rank's share, the
shares summing to the whole, and the parameters' gradients are summed over
the ring once (:func:`sum_grads_over_seq`).  The sequence-parallel attention
wrappers keep to this contract: the key and value gradients of another
rank's frames are summed over the ring and handed to their owner, those of
the replicated text and ref stay where they are.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

_ACTIVE: Dict[str, Optional[object]] = {"mesh": None, "map": None}


@contextlib.contextmanager
def mesh_context(mesh, logical_to_mesh: Dict[str, Optional[str]]):
    """Activate a mesh and a logical -> mesh-dim mapping, e.g.
    ``{"dp": None, "tp": None, "sp": "seq"}``; the previous ones come back
    on exit."""
    prev = (_ACTIVE["mesh"], _ACTIVE["map"])
    _ACTIVE["mesh"], _ACTIVE["map"] = mesh, dict(logical_to_mesh)
    try:
        yield
    finally:
        _ACTIVE["mesh"], _ACTIVE["map"] = prev


def active_mesh():
    return _ACTIVE["mesh"]


def active_axis(logical: str) -> Optional[str]:
    """The mesh dim a logical axis (``"dp"``/``"tp"``/``"sp"``) is mapped to, if any."""
    mapping = _ACTIVE["map"]
    return mapping.get(logical) if mapping else None


def default_logical_map(mesh) -> Dict[str, Optional[str]]:
    """Map the logical axes to the dims this mesh has
    (``s2v_tpu/parallel/sharding.py:221``)."""
    names = set(mesh.mesh_dim_names or ())
    return {"dp": "data" if "data" in names else None, "tp": "model" if "model" in names else None,
            "sp": "seq" if "seq" in names else None}


def seq_group(backend: str = "sequence-parallel attention") -> Tuple[object, int, int]:
    """(process group, ring size, this rank) of the active mesh's ``sp``
    dim.  Raises ``ValueError`` without one, and ``NotImplementedError``
    when the mapping also names a data or model dim (ROADMAP A.9)."""
    mesh, axis = active_mesh(), active_axis("sp")
    if mesh is None or axis is None:
        raise ValueError(f"{backend} needs an active mesh with an 'sp' axis (S2VPipeline.set_mesh, or "
                         f"s2v_torch.parallel.mesh_context)")
    if active_axis("dp") is not None or active_axis("tp") is not None:
        raise NotImplementedError(f"{backend} under a data or model mesh dim is not ported yet (ROADMAP A.9)")
    group = mesh.get_group(axis)
    return group, dist.get_world_size(group), dist.get_rank(group)


def active_seq_ring() -> int:
    """Ranks of the active mesh's ``sp`` dim; 1 outside a mesh context."""
    mesh, axis = active_mesh(), active_axis("sp")
    if mesh is None or axis is None:
        return 1
    return mesh.size(list(mesh.mesh_dim_names).index(axis))


@dataclass(frozen=True)
class FrameShard:
    """The video frames one rank of a ``seq`` ring owns: ``local_frames``
    frames from global frame ``first_frame``, of which ``real_frames`` lie in
    the clip and the rest are dummy frames."""

    n_frames: int  # F: latent frames of the clip
    tokens_per_frame: int
    ring: int
    rank: int
    group: Optional[object] = None  # the ring's process group (None: one rank, no collectives)

    def __post_init__(self):
        if self.ring > self.n_frames:
            # B6/B7 and the frame layout take rings of at most F ranks
            raise ValueError(f"a seq ring of {self.ring} ranks needs at least {self.ring} latent frames; the clip "
                             f"has {self.n_frames} (rings with more ranks than frames: ROADMAP A.9)")

    @property
    def local_frames(self) -> int:
        return -(-self.n_frames // self.ring)

    @property
    def first_frame(self) -> int:
        return self.rank * self.local_frames

    def real_frames_of(self, rank: int) -> int:
        return max(0, min(self.local_frames, self.n_frames - rank * self.local_frames))

    @property
    def real_frames(self) -> int:
        return self.real_frames_of(self.rank)

    @property
    def local_rows(self) -> int:
        """Video rows a rank holds, dummy frames included."""
        return self.local_frames * self.tokens_per_frame

    @property
    def video_rows(self) -> int:
        """Video rows of the whole clip."""
        return self.n_frames * self.tokens_per_frame

    def dummy_key_mask(self, rank: int, lead: int, device) -> Optional[torch.Tensor]:
        """``[lead + local_rows]`` bool, True on the dummy frames' rows of
        ``rank``'s shard (after ``lead`` rows that are all real), or None
        when that shard has none."""
        real = self.real_frames_of(rank) * self.tokens_per_frame
        if real == self.local_rows:
            return None
        mask = torch.zeros(lead + self.local_rows, dtype=torch.bool, device=device)
        mask[lead + real:] = True
        return mask

    def take(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """This rank's rows of the video rows ``x`` (``video_rows`` along
        ``dim``), zero on the dummy frames."""
        lo = self.first_frame * self.tokens_per_frame
        hi = min(lo + self.local_rows, self.video_rows)
        piece = x.narrow(dim, min(lo, self.video_rows), max(0, hi - lo))
        pad = self.local_rows - piece.shape[dim]
        if pad == 0:
            return piece
        shape = list(x.shape)
        shape[dim] = pad
        return torch.cat([piece, x.new_zeros(shape)], dim=dim)


def frame_shard(n_frames: int, tokens_per_frame: int, backend: str = "sequence-parallel attention") -> FrameShard:
    """This rank's :class:`FrameShard` on the active mesh's ``sp`` dim."""
    group, ring, rank = seq_group(backend)
    return FrameShard(n_frames, tokens_per_frame, ring, rank, group)


def all_gather_rows(x: torch.Tensor, group, ring: int, dim: int = 1) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in rank order."""
    xt = x.movedim(dim, 0).contiguous()
    buf = torch.empty((ring * xt.shape[0], *xt.shape[1:]), dtype=x.dtype, device=x.device)
    dist.all_gather(list(buf.chunk(ring)), xt, group=group)
    return buf.movedim(0, dim)


def sum_and_take(x: torch.Tensor, shard: FrameShard, dim: int = 1) -> torch.Tensor:
    """The transpose of gathering every rank's video rows: ``x`` holds this
    rank's share of a gradient over the whole clip's ``video_rows``; summed
    over the ring, this rank's rows (zero on its dummy frames).  gloo has no
    reduce_scatter, so an all_reduce and a slice."""
    x = x.contiguous()
    dist.all_reduce(x, group=shard.group)
    return shard.take(x, dim)


class _GatherVideo(torch.autograd.Function):
    """Every rank's video rows gathered; the backward keeps this rank's rows
    of a gradient every rank holds alike (the consumer is replicated)."""

    @staticmethod
    def forward(ctx, x, shard, dim):
        ctx.shard, ctx.dim = shard, dim
        return all_gather_rows(x, shard.group, shard.ring, dim).narrow(dim, 0, shard.video_rows).contiguous()

    @staticmethod
    def backward(ctx, g):
        return ctx.shard.take(g, ctx.dim).contiguous(), None, None


def gather_video(x: torch.Tensor, shard: FrameShard, dim: int = 1) -> torch.Tensor:
    """``[.., local_rows, ..]`` on each rank -> the clip's ``[..,
    video_rows, ..]`` on every rank, dummy frames dropped."""
    return _GatherVideo.apply(x, shard, dim)


class _SumGrads(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def sum_grads_over_seq(tree):
    """On an active ``seq`` ring above 1: every tensor of the tree that
    requires a gradient passed through an identity whose backward sums the
    gradient over the ring, so each rank ends with the whole gradient.
    Elsewhere the tree as it is."""
    if active_seq_ring() <= 1:
        return tree
    group, _, _ = seq_group()

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v) for v in t)
        if isinstance(t, torch.Tensor) and t.requires_grad and torch.is_grad_enabled():
            return _SumGrads.apply(t, group)
        return t

    return walk(tree)
