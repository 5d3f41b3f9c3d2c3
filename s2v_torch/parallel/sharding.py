"""Mesh specs, meshes and parameter placements (counterpart of
``s2v_tpu/parallel/sharding.py``: ``make_mesh`` :29,
``transformer_param_specs`` :56, ``t5_param_specs`` :105,
``parse_mesh_spec`` :130, ``transformer_param_specs_like`` :172,
``shard_params`` :210; and of ``s2v_tpu/training/full.py``'s
``fsdp_param_specs`` and ``combined_param_specs``).  ``default_logical_map``
(:221) is ``parallel/context.py``'s; ``replicate`` (:217) has no
counterpart: every process holds its own copy of what is not sharded.

The grammar is JAX's whole (``"sp8"``, ``"seq8"``, ``"dp2,tp4"``, or a dict
of sizes), so error texts name the same axes.  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` whose dims are named ``data``,
``seq`` and ``model``, in the spec's order, one process per card.

A placement (:class:`Placement`) says how a rank holds a leaf of a parameter
tree: megatron TP slices one dim over ``model`` (column-parallel linears
their output rows, row-parallel ones their input columns, in the port's
``[out, in]`` layouts; int8 ``q`` ``[out, in]`` and ``scale`` ``[out]``
alike), then FSDP shards one more dim over ``data``.  JAX's GSPMD needs
only the spec; here each rank keeps the slice itself
(:func:`shard_params`) and the model code runs on it.

By design (ROADMAP C.29): the fused qkv ``[3D, D]`` is sliced per head,
not contiguously.  JAX shards its ``[D, 3D]`` kernel contiguously
(``P(None, None, m)``) and GSPMD reshards after the split into heads; a
contiguous slice here would hand rank 0 all of q and half of k.  Rank r
takes rows ``[i·D + r·D/tp, i·D + (r+1)·D/tp)`` of q, k and v (i = 0, 1,
2), so its heads are whole; the results are JAX's.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple, Union

import torch
import torch.distributed as dist

from s2v_torch.utils.device import needs_grad

# logical and mesh names of the axes (s2v_tpu/parallel/sharding.py:139-140)
_ALIAS = {"dp": "data", "tp": "model", "sp": "seq", "data": "data", "model": "model", "seq": "seq"}
# leaves below this many elements stay whole under FSDP (JAX's fsdp_min_size)
FSDP_MIN_SIZE = 2 ** 14


def parse_mesh_spec(spec: str) -> Dict[str, int]:
    """CLI mesh grammar -> axis sizes, e.g. ``"dp2,tp4"`` -> ``{"data": 2,
    "model": 4}`` and ``"sp8"`` -> ``{"seq": 8}``; axis order preserved."""
    out: Dict[str, int] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        name = part.rstrip("0123456789")
        size = part[len(name):]
        if name not in _ALIAS or not size:
            raise ValueError(f"bad mesh spec {part!r} (want e.g. 'dp2,tp4' or 'sp8'; axes: dp/data, tp/model, "
                             f"sp/seq)")
        if _ALIAS[name] in out:
            raise ValueError(f"duplicate mesh axis {name!r} in {spec!r}")
        if int(size) < 1:
            raise ValueError(f"mesh axis {part!r} must have size >= 1")
        out[_ALIAS[name]] = int(size)
    if not out:
        raise ValueError(f"empty mesh spec {spec!r}")
    return out


def mesh_sizes(spec) -> Dict[str, int]:
    """The dim sizes by mesh name of a spec string, a dict of sizes (logical
    or mesh names) or a ``DeviceMesh``, in its order."""
    if spec is None:
        return {}
    if isinstance(spec, str):
        return parse_mesh_spec(spec)
    if isinstance(spec, dict):
        return {_ALIAS.get(k, k): int(v) for k, v in spec.items()}
    return {name: spec.size(i) for i, name in enumerate(spec.mesh_dim_names or ())}


def seq_mesh_size(spec: Union[str, Dict[str, int]]) -> int:
    """The ``seq`` ring of a spec (1 when it has no ``seq`` dim)."""
    return mesh_sizes(spec).get("seq", 1)


def make_mesh(spec: Union[str, Dict[str, int]], device_type: str):
    """A ``DeviceMesh`` of the spec's dims, in its order, over the default
    process group, which :func:`s2v_torch.parallel.multihost.initialize_distributed`
    makes when it is not there yet.  The sizes' product must be the world
    size."""
    from torch.distributed.device_mesh import init_device_mesh

    from s2v_torch.parallel.multihost import initialize_distributed

    sizes = mesh_sizes(spec)
    initialize_distributed(device_type)
    world, n = dist.get_world_size(), math.prod(sizes.values())
    if n != world:
        raise ValueError(f"mesh {spec!r} has {n} ranks but the process group has {world} (start one process "
                         f"per card: torchrun --nproc_per_node {n})")
    return init_device_mesh(device_type, tuple(sizes.values()), mesh_dim_names=tuple(sizes))


@contextlib.contextmanager
def entry_point_mesh(spec: Optional[str], device_type: str):
    """An entry point's ``--mesh``: the mesh of the spec (None without one),
    and the default process group, if this made it, destroyed on exit."""
    if spec is None:
        yield None
        return
    made = not dist.is_initialized()
    try:
        yield make_mesh(spec, device_type)
    finally:
        if made and dist.is_initialized():
            dist.destroy_process_group()


# ---------------------------------------------------------------------------
# placements
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Placement:
    """How a rank holds a leaf: ``model_dim`` sliced over ``model`` (in
    ``blocks`` equal parts, each sliced alike: 3 for the fused qkv), then
    ``data_dim`` of that slice sharded over ``data``.  Both None: whole."""

    model_dim: Optional[int] = None
    blocks: int = 1
    data_dim: Optional[int] = None

    def to_json(self) -> dict:
        return {"model_dim": self.model_dim, "blocks": self.blocks, "data_dim": self.data_dim}

    @staticmethod
    def from_json(d: dict) -> "Placement":
        return Placement(d["model_dim"], d["blocks"], d["data_dim"])


WHOLE = Placement()

# TP rules by module path (s2v_tpu/parallel/sharding.py:164-169): column-
# parallel linears slice their output rows, row-parallel ones their input
# columns; norm1/norm2 slice only their adaLN linears
_COL_PARALLEL = ("qkv", "net_0", "to_q", "to_k", "to_v", "norm1/linear", "norm1/base_linear", "norm2/linear",
                 "norm2/base_linear")
_ROW_PARALLEL = ("to_out", "net_2")
# the fused qkv's rows are q | k | v: each sliced by heads
_PER_HEAD_BLOCKS = {"qkv": 3}


def _tree_map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _tree_map_with_path(fn, v, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map_with_path(fn, v, path + (str(i),)) for i, v in enumerate(tree))
    return fn(path, tree)


def tp_leaf_placement(path: Tuple[str, ...], ndim: int) -> Placement:
    """The megatron placement of the transformer leaf at ``path`` (keys of
    the port's tree) with ``ndim`` dims."""
    joined = "/" + "/".join(path) + "/"
    if "runtime_lora" in joined or ndim == 0 or "/blocks/" not in joined:
        return WHOLE  # the factors are replicated: the delta inherits the kernel's slice
    leaf = path[-1]
    for name in _COL_PARALLEL:
        if f"/{name}/" in joined:
            return Placement(0, _PER_HEAD_BLOCKS.get(name, 1))  # weight/q [out, in], bias/scale [out]
    for name in _ROW_PARALLEL:
        if f"/{name}/" in joined and leaf in ("weight", "q") and ndim >= 2:
            return Placement(ndim - 1)  # the input columns; bias and scale are per output: whole
    return WHOLE


def transformer_param_specs_like(params) -> dict:
    """The megatron placement of every leaf of a transformer tree, bf16 or
    int8 (``:172``)."""
    return _tree_map_with_path(lambda path, x: tp_leaf_placement(path, getattr(x, "ndim", 0)), params)


def transformer_param_specs(cfg) -> dict:
    """:func:`transformer_param_specs_like` of the tree ``cfg`` describes (``:56``)."""
    from s2v_torch.models.transformer import init_transformer_params_random

    return transformer_param_specs_like(init_transformer_params_random(cfg, device="meta"))


def t5_param_specs(params) -> dict:
    """Megatron placements of the T5 encoder (``:105``): q/k/v and ``wi_*``
    column-parallel (heads and d_ff), ``o``/``wo`` row-parallel, the
    relative-attention bias table by heads, embeddings and RMSNorm weights
    whole."""

    def spec(path, x):
        if "blocks" in path:
            if any(k in path for k in ("q", "k", "v", "wi_0", "wi_1")):
                return Placement(0)
            if any(k in path for k in ("o", "wo")):
                return Placement(1)
            return WHOLE
        if "relative_attention_bias" in path:
            return Placement(1)  # [num_buckets, H]
        return WHOLE

    return _tree_map_with_path(spec, params)


def _best_data_dim(shape, taken, axis_size: int) -> int:
    """Largest ``axis_size``-divisible dimension not already sharded (ties:
    the later dimension); -1 if none (``s2v_tpu/training/full.py:89``)."""
    best = -1
    for i, d in enumerate(shape):
        if i not in taken and d % axis_size == 0 and (best < 0 or d >= shape[best]):
            best = i
    return best


def local_shape(shape, p: Placement, sizes: Dict[str, int]) -> Tuple[int, ...]:
    """A leaf's shape on one rank under ``p`` on a mesh of ``sizes``."""
    out = list(shape)
    if p.model_dim is not None:
        out[p.model_dim] //= sizes.get("model", 1)
    if p.data_dim is not None:
        out[p.data_dim] //= sizes.get("data", 1)
    return tuple(out)


def _with_data_dim(x, p: Placement, sizes: Dict[str, int], min_size: int) -> Placement:
    shape = tuple(getattr(x, "shape", ()))
    if not shape or math.prod(shape) < min_size:
        return p
    taken = () if p.model_dim is None else (p.model_dim,)
    best = _best_data_dim(local_shape(shape, p, sizes), taken, sizes["data"])
    return p if best < 0 else Placement(p.model_dim, p.blocks, best)


def fsdp_param_specs(params, axis_size: int, min_size: int = FSDP_MIN_SIZE) -> dict:
    """FSDP placements (``s2v_tpu/training/full.py:99``): each leaf of at
    least ``min_size`` elements shards its largest ``axis_size``-divisible
    dim over ``data`` (ties: the later dim); smaller leaves stay whole.
    ``axis_size`` 1 shards too: a named dim runs the sharded code."""
    return _tree_map_with_path(lambda path, x: _with_data_dim(x, WHOLE, {"data": axis_size}, min_size), params)


def combined_param_specs(params, data_size: int, model_size: int, min_size: int = FSDP_MIN_SIZE) -> dict:
    """FSDP × TP placements (``s2v_tpu/training/full.py:127``): the
    megatron placement first, then the largest remaining divisible dim of
    the model slice over ``data``."""
    sizes = {"data": data_size, "model": model_size}
    return _tree_map_with_path(
        lambda path, x: _with_data_dim(x, tp_leaf_placement(path, getattr(x, "ndim", 0)), sizes, min_size), params)


def take_slice(x: torch.Tensor, dim: int, blocks: int, rank: int, size: int, what: str) -> torch.Tensor:
    n = x.shape[dim]
    if n % (blocks * size):
        raise ValueError(f"{what}: dim {dim} of {tuple(x.shape)} does not split into {blocks} x {size} equal parts "
                         f"(a mesh dim of {size} ranks does not fit the model)")
    part, width = n // blocks, n // (blocks * size)
    pieces = [x.narrow(dim, i * part + rank * width, width) for i in range(blocks)]
    return pieces[0] if blocks == 1 else torch.cat(pieces, dim)


def coords(mesh) -> Dict[str, Tuple[int, int]]:
    """(rank, size) of this process on each dim of the mesh."""
    out = {}
    for name in mesh.mesh_dim_names or ():
        group = mesh.get_group(name)
        out[name] = (dist.get_rank(group), dist.get_world_size(group))
    return out


def shard_tensor(x: torch.Tensor, p: Placement, where: Dict[str, Tuple[int, int]], what: str = "leaf"):
    """This rank's slice of the whole ``x`` under ``p`` (a view when it can be)."""
    if p.model_dim is not None and "model" in where:
        x = take_slice(x, p.model_dim, p.blocks, *where["model"], what)
    if p.data_dim is not None and "data" in where:
        x = take_slice(x, p.data_dim, 1, *where["data"], what)
    return x


def shard_params(params, mesh, specs, dtype: Optional[torch.dtype] = None, device=None):
    """Each leaf's slice for this rank (``:210``), cast to ``dtype`` (floating
    leaves) and copied to ``device`` after the slice, so only the slice is
    ever cast or moved.  A leaf that does not split raises, naming it."""
    where = coords(mesh)

    def place(path, x):
        if not isinstance(x, torch.Tensor):
            return x
        p = spec_at(specs, path)
        local = shard_tensor(x, p, where, "/".join(path))
        cast = dtype if dtype is not None and local.is_floating_point() else local.dtype
        return local.to(device=device if device is not None else local.device, dtype=cast, copy=True).contiguous()

    return _tree_map_with_path(place, params)


def spec_at(specs, path):
    node = specs
    for key in path:
        node = node[int(key)] if isinstance(node, (list, tuple)) else node[key]
    return node


def gather_tensor(x: torch.Tensor, p: Placement, mesh) -> torch.Tensor:
    """The whole leaf from every rank's slice: all-gathered over ``data``,
    then over ``model`` (the per-head blocks put back in order)."""
    names = mesh.mesh_dim_names or ()
    if p.data_dim is not None and "data" in names:
        x = _all_gather_dim(x, p.data_dim, mesh.get_group("data"))
    if p.model_dim is not None and "model" in names:
        group = mesh.get_group("model")
        size = dist.get_world_size(group)
        parts = _all_gather_dim(x, p.model_dim, group).chunk(size, p.model_dim)
        if p.blocks > 1:
            parts = [blk for i in range(p.blocks) for blk in (q.chunk(p.blocks, p.model_dim)[i] for q in parts)]
        x = torch.cat(parts, p.model_dim)
    return x


def _all_gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    size = dist.get_world_size(group)
    xt = x.movedim(dim, 0).contiguous()
    buf = torch.empty((size * xt.shape[0], *xt.shape[1:]), dtype=x.dtype, device=x.device)
    dist.all_gather(list(buf.chunk(size)), xt, group=group)
    return buf.movedim(0, dim).contiguous()  # a weight's layout decides its matmul's rounding


def gather_params(params, mesh, specs, dtype: Optional[torch.dtype] = None, device=None):
    """The whole tree from every rank's slices, floating leaves cast to
    ``dtype`` after the gather, on ``device`` (default: where they are)."""

    def whole(path, x):
        if not isinstance(x, torch.Tensor):
            return x
        full = gather_tensor(x, spec_at(specs, path), mesh)
        cast = dtype if dtype is not None and full.is_floating_point() else full.dtype
        return full.to(device=device if device is not None else full.device, dtype=cast)

    return _tree_map_with_path(whole, params)


def per_rank_bytes(params, specs, sizes: Dict[str, int]) -> int:
    """Bytes one rank holds of ``params`` (tensors, ``meta`` ones included)
    under ``specs`` on a mesh of ``sizes``: computed from the shapes."""
    total = [0]

    def add(path, x):
        if isinstance(x, torch.Tensor):
            total[0] += math.prod(local_shape(x.shape, spec_at(specs, path), sizes)) * x.element_size()
        return x

    _tree_map_with_path(add, params)
    return total[0]


class _GatherShards(torch.autograd.Function):
    """FSDP's per-block gather: every ``data`` rank's shard concatenated
    along ``dim``; the backward sums this rank's share of the whole
    gradient over ``data`` and keeps its own shard (gloo has no
    reduce_scatter: an all_reduce and a slice)."""

    @staticmethod
    def forward(ctx, x, dim, dp):
        ctx.dim, ctx.dp = dim, dp
        return _all_gather_dim(x, dim, dp.group)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.dp.group)
        return g.narrow(ctx.dim, ctx.dp.rank * (g.shape[ctx.dim] // ctx.dp.size),
                        g.shape[ctx.dim] // ctx.dp.size).contiguous(), None, None


class ParamGather:
    """``transformer_forward``'s ``param_gather`` for a tree sharded over
    ``data`` by ``specs``: each leaf with a ``data_dim`` all-gathered there
    (its model-dim slice stays), the others as they are."""

    def __init__(self, specs: dict, dp):
        self.specs, self.dp = specs, dp

    def __call__(self, key, tree):
        specs = self.specs if key == "top" else self.specs["blocks"][key]

        def whole(path, x):
            p = spec_at(specs, path)
            if not isinstance(x, torch.Tensor) or p.data_dim is None:
                return x
            if needs_grad(x):
                return _GatherShards.apply(x, p.data_dim, self.dp)
            return _all_gather_dim(x, p.data_dim, self.dp.group)

        return _tree_map_with_path(whole, tree)
