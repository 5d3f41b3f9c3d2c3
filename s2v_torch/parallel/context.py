"""Logical-axis mesh context, the frame shards of a ``seq`` ring, and the
collectives of the ``data`` and ``model`` dims (counterpart of
``s2v_tpu/parallel/context.py``).

Model code asks :func:`active_mesh` and :func:`active_axis` for the mesh and
the name of the mesh dimension a *logical* axis (``"dp"``/``"sp"``/``"tp"``)
is mapped to; outside a :func:`mesh_context` both are None, so single-card
paths run unchanged.  The mesh is a
``torch.distributed.device_mesh.DeviceMesh`` whose dims carry names, as a
``jax.sharding.Mesh``'s axes do; its process group must already be
initialised.

``constrain`` (``with_sharding_constraint`` for GSPMD) has no PyTorch
counterpart; the port shards by hand instead, at every size of a dim the
mesh names (a one-rank dim runs the same collectives, which copy):

* ``seq``: the DiT's video stream split by latent frames (:class:`FrameShard`):
  rank r holds frames ``r·F_loc .. r·F_loc + F_loc - 1`` with ``F_loc =
  ceil(F / ring)``, the frames past F being zero *dummy* frames (the ring
  padding of ``BandGeometry.shard``/``ring_shards``).  The text and ref
  streams stay whole on every rank: each rank computes them alike.  (A ring
  of 1 keeps the whole clip, as before the other dims were ported.)
* ``data``: the batch split into equal contiguous rows (:func:`take_rows`),
  gathered after the DiT (:func:`gather_rows_over`); without a gradient a
  batch the dim does not divide is padded with dummy rows, dropped after the
  gather (ROADMAP C.32).
* ``model``: megatron TP (:class:`TensorParallel`): column-parallel linears
  take their input through :func:`copy_to_model` (identity forward, the
  gradient all-reduced), row-parallel ones hand their partial output to
  :func:`reduce_from_model` (all-reduced forward, identity backward); the
  adaLN's column-sliced modulation is all-gathered (:func:`gather_columns`).

Gradient contract of the sharded model: each rank's backward carries its own
share of the loss.  The rows of the DiT's output are gathered over ``seq``
(:func:`gather_video`) and ``data``, and each gather's backward keeps this
rank's rows of a gradient that every rank holds alike, so each row's loss
is counted on one rank.  A tensor replicated over ``seq`` or ``data`` then
gets this rank's share of its gradient, the shares summing to the whole, and
parameters' gradients are summed over those dims once (:func:`sum_grads`).
Over ``model`` the replicated activations' gradients are whole on every
rank (the megatron operators make them so); what a rank computes from its
own heads only (the per-head qk norms, the row-parallel bias added on
model rank 0, the LoRA factors whose delta is sliced) is a partial sum over
``model`` and summed there.  The sequence-parallel attention wrappers keep
to this contract: the key and value gradients of another rank's frames are
summed over the ring and handed to their owner, those of the replicated
text and ref stay where they are.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from s2v_torch.utils.device import needs_grad

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
    dim.  Raises ``ValueError`` without one."""
    mesh, axis = active_mesh(), active_axis("sp")
    if mesh is None or axis is None:
        raise ValueError(f"{backend} needs an active mesh with an 'sp' axis (S2VPipeline.set_mesh, or "
                         f"s2v_torch.parallel.mesh_context)")
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
    the clip and the rest are dummy frames.  A ring with more ranks than
    frames gives every rank one frame, and the ranks past F a dummy one."""

    n_frames: int  # F: latent frames of the clip
    tokens_per_frame: int
    ring: int
    rank: int
    group: Optional[object] = None  # the ring's process group (None: one rank, no collectives)

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


def sum_grads_over_seq(tree):
    """On an active ``seq`` ring above 1: :func:`sum_grads` over the ring.
    Elsewhere the tree as it is."""
    return sum_grads(tree, ("sp",))


# ---------------------------------------------------------------------------
# the data and model dims
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class DimGroup:
    """A mesh dim's process group, its size and this rank on it."""

    group: object
    size: int
    rank: int


def dim_group(logical: str) -> Optional[DimGroup]:
    """The active mesh's dim a logical axis (``"dp"``/``"tp"``/``"sp"``) maps
    to, or None when no mesh is active or it has no such dim."""
    mesh, axis = active_mesh(), active_axis(logical)
    if mesh is None or axis is None:
        return None
    group = mesh.get_group(axis)
    return DimGroup(group, dist.get_world_size(group), dist.get_rank(group))


def tensor_parallel() -> Optional[DimGroup]:
    """The ``model`` dim of the active mesh (megatron TP), or None."""
    return dim_group("tp")


def data_parallel() -> Optional[DimGroup]:
    """The ``data`` dim of the active mesh, or None."""
    return dim_group("dp")


class _CopyToModel(torch.autograd.Function):
    """Megatron's f: identity forward, the gradient all-reduced over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    """Megatron's g: the partial sums all-reduced forward, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor, tp: DimGroup) -> torch.Tensor:
    """The input of a column-parallel linear (or a leaf a rank uses on its
    own heads only): the same tensor, whose gradient, a partial sum over
    ``model``, is all-reduced there.  Without autograd, ``x``."""
    return _CopyToModel.apply(x, tp.group) if needs_grad(x) else x


def reduce_from_model(x: torch.Tensor, tp: DimGroup) -> torch.Tensor:
    """The output of a row-parallel linear: the ranks' partial sums added."""
    if needs_grad(x):
        return _ReduceFromModel.apply(x, tp.group)
    x = x.contiguous()
    dist.all_reduce(x, group=tp.group)
    return x


class _GatherLast(torch.autograd.Function):
    """Every rank's columns concatenated; the backward keeps this rank's
    columns of a gradient every rank holds alike (the consumer is replicated)."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return all_gather_rows(x, tp.group, tp.size, dim=x.dim() - 1).contiguous()

    @staticmethod
    def backward(ctx, g):
        w = g.shape[-1] // ctx.tp.size
        return g.narrow(-1, ctx.tp.rank * w, w).contiguous(), None


def gather_columns(x: torch.Tensor, tp: DimGroup) -> torch.Tensor:
    """A column-parallel output ``[..., N/tp]`` -> ``[..., N]`` on every rank."""
    if needs_grad(x):
        return _GatherLast.apply(x, tp)
    return all_gather_rows(x, tp.group, tp.size, dim=x.dim() - 1).contiguous()


def take_rows(x: Optional[torch.Tensor], dp: DimGroup, what: str = "batch",
              pad: bool = False) -> Optional[torch.Tensor]:
    """This rank's equal contiguous rows of ``x`` along dim 0, as JAX's
    ``P("data")`` lays a batch out.  A batch the dim does not divide raises,
    unless ``pad``: then it is first padded to a multiple of the dim with
    copies of its last row (dummy rows: a statistic taken over a rank's rows,
    such as B3's amax or B1's bound, sees nothing a real row does not hold),
    which the caller drops after :func:`gather_rows_over` (ROADMAP C.32; JAX's
    GSPMD shards an uneven batch)."""
    if x is None:
        return None
    extra = -x.shape[0] % dp.size
    if extra:
        if not pad:
            raise ValueError(f"a {what} of {x.shape[0]} rows does not split over a data mesh dim of {dp.size} "
                             f"ranks")
        x = torch.cat([x, x[-1:].expand(extra, *x.shape[1:])], dim=0)
    n = x.shape[0] // dp.size
    return x.narrow(0, dp.rank * n, n)


class _GatherBatch(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dp):
        ctx.dp = dp
        return all_gather_rows(x, dp.group, dp.size, dim=0).contiguous()

    @staticmethod
    def backward(ctx, g):
        return take_rows(g, ctx.dp).contiguous(), None


def gather_rows_over(x: torch.Tensor, dp: DimGroup) -> torch.Tensor:
    """Every data rank's rows in rank order; the backward keeps this rank's
    rows of a gradient every rank holds alike."""
    if needs_grad(x):
        return _GatherBatch.apply(x, dp)
    return all_gather_rows(x, dp.group, dp.size, dim=0)


class _SumOver(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over each group."""

    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        for group in ctx.groups:
            dist.all_reduce(g, group=group)
        return g, None


def _replica_groups(dims) -> list:
    """The groups of the named logical dims that hold shares: ``seq`` only
    above one rank (its ring of 1 keeps the whole clip), ``data`` and
    ``model`` at any size."""
    groups = []
    for logical in dims:
        if logical == "sp" and active_seq_ring() <= 1:
            continue
        g = dim_group(logical)
        if g is not None:
            groups.append(g.group)
    return groups


def sum_grads(tree, dims=("sp", "dp"), where=None):
    """Every tensor of the tree that requires a gradient passed through an
    identity whose backward sums its gradient over the active mesh's
    ``dims`` (logical names), so each rank ends with the whole gradient.
    ``where(path)``, when given, picks the leaves (by their key path) and
    may return other dims for a leaf.  Without such a dim the tree as it is."""
    default = _replica_groups(dims)

    def walk(t, path):
        if isinstance(t, dict):
            return {k: walk(v, path + (k,)) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v, path + (i,)) for i, v in enumerate(t))
        if isinstance(t, torch.Tensor) and needs_grad(t):
            groups = default if where is None else _replica_groups(where(path))
            return _SumOver.apply(t, groups) if groups else t
        return t

    return walk(tree, ())
