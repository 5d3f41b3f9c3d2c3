"""A resumable train state: the port's stand-in for
``s2v_tpu/loaders/orbax_io.py`` (``save_params_orbax`` /
``load_params_orbax``), which is JAX-only.

A state is a nested tree of dicts, lists and tuples whose leaves are tensors
(on any device, any dtype ``safetensors_io`` writes) or plain scalars
(int, float, bool, str, None): the trainer's ``{"lora" or "params",
"opt_state", "step"}``, the optimizer state's ``count``, ``mu``, ``nu``,
``mini_step``, ``acc``, prodigy's fields and full mode's ``(state, ema)``
pair.  On disk, a directory holds

* ``tensors.safetensors``: every tensor leaf, named by its path in the tree
  (keys joined with ``/``), through ``s2v_torch/loaders/safetensors_io.py``;
* ``tree.json``: the tree's structure, each tensor leaf as its name with
  dtype and shape, each scalar as its value.

The directory is written under a temporary name and renamed into place, so
a half-written state is never found.

On a mesh (``mesh=``, one process per card) each rank writes the tensors it
holds, its shards, as ``tensors.rank<r>-of-<n>.safetensors`` (r its rank in
the default group); rank 0 writes ``tree.json``, which also records the
mesh's dim sizes in order and, by tensor name, each sharded leaf's placement
(``parallel/sharding.py::Placement``).  A state reads back on a mesh of the
same sizes only, each rank its own file, bit for bit; another mesh, or a
single-card state on a mesh and the reverse, raises naming both (by design,
ROADMAP C.31: orbax could reshard, the port does not).
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Optional

import torch
import torch.distributed as dist

from s2v_torch.loaders.safetensors_io import load_safetensors, save_safetensors

TENSORS_FILE = "tensors.safetensors"
TREE_FILE = "tree.json"
FORMAT = "s2v_torch train state 1"
SHARDED_FORMAT = "s2v_torch sharded train state 1"


def rank_file(rank: int, world: int) -> str:
    return f"tensors.rank{rank}-of-{world}.safetensors"


def _mesh_items(mesh) -> list:
    from s2v_torch.parallel.sharding import mesh_sizes

    return [[k, v] for k, v in mesh_sizes(mesh).items()]


def _encode(tree, path: str, tensors: dict):
    if isinstance(tree, dict):
        for key in tree:
            if not isinstance(key, str) or "/" in key:
                raise ValueError(f"train state keys must be strings without '/'; {path!r} has {key!r}")
        return {"dict": {k: _encode(v, f"{path}/{k}", tensors) for k, v in tree.items()}}
    if isinstance(tree, (list, tuple)):
        kind = "list" if isinstance(tree, list) else "tuple"
        return {kind: [_encode(v, f"{path}/{i}", tensors) for i, v in enumerate(tree)]}
    if isinstance(tree, torch.Tensor):
        name = path.lstrip("/") or "."
        tensors[name] = tree
        return {"tensor": name, "dtype": str(tree.dtype).replace("torch.", ""), "shape": list(tree.shape)}
    if tree is None or isinstance(tree, (bool, int, float, str)):
        return {"value": tree}
    raise TypeError(f"train state leaf at {path!r} is a {type(tree).__name__}")


def save_train_state(state, path: str, mesh=None, placements: Optional[dict] = None) -> str:
    """Write ``state`` (see the module doc) as the directory ``path``,
    replacing one that is there.  Returns the path.  With ``mesh`` every
    rank calls it with its own shards; ``placements`` maps tensor names to
    their placements' JSON (the others are whole on every rank)."""
    tensors: dict = {}
    tree = _encode(state, "", tensors)
    path = os.path.abspath(path)
    tmp = path + ".tmp"
    if mesh is None:
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        save_safetensors(tensors, os.path.join(tmp, TENSORS_FILE))
        with open(os.path.join(tmp, TREE_FILE), "w") as f:
            json.dump({"format": FORMAT, "tree": tree}, f)
        shutil.rmtree(path, ignore_errors=True)
        os.replace(tmp, path)
        return path
    rank, world = dist.get_rank(), dist.get_world_size()
    if rank == 0:
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
    dist.barrier()
    save_safetensors(tensors, os.path.join(tmp, rank_file(rank, world)))
    dist.barrier()
    if rank == 0:
        with open(os.path.join(tmp, TREE_FILE), "w") as f:
            json.dump({"format": SHARDED_FORMAT, "mesh": _mesh_items(mesh), "world_size": world, "tree": tree,
                       "placements": placements or {}}, f)
        shutil.rmtree(path, ignore_errors=True)
        os.replace(tmp, path)
    dist.barrier()
    return path


def _decode(node, target, path: str, tensors: dict, device):
    """The saved ``node`` as the tree of ``target``'s structure; raises
    ``ValueError`` naming the first path where the two differ."""
    kind = next(iter(node))
    if isinstance(target, dict):
        if kind != "dict" or sorted(node["dict"]) != sorted(target):
            raise ValueError(f"{path or '/'}: saved {kind} with keys {sorted(node.get('dict', {}))}, "
                             f"target dict with keys {sorted(target)}")
        return {k: _decode(node["dict"][k], v, f"{path}/{k}", tensors, device) for k, v in target.items()}
    if isinstance(target, (list, tuple)):
        want = "list" if isinstance(target, list) else "tuple"
        if kind != want or len(node[kind]) != len(target):
            raise ValueError(f"{path or '/'}: saved {kind} of {len(node.get(kind, []))} "
                             f"(or another container), target {want} of {len(target)}")
        return type(target)(_decode(n, t, f"{path}/{i}", tensors, device) for i, (n, t) in
                            enumerate(zip(node[kind], target)))
    if isinstance(target, torch.Tensor):
        if kind != "tensor":
            raise ValueError(f"{path}: saved a {kind}, target a tensor")
        saved = tensors[node["tensor"]]
        if saved.dtype != target.dtype or tuple(saved.shape) != tuple(target.shape):
            raise ValueError(f"{path}: saved {saved.dtype} {tuple(saved.shape)}, target {target.dtype} "
                             f"{tuple(target.shape)}")
        return saved.to(device if device is not None else target.device, copy=True)
    if kind != "value" or type(node["value"]) is not type(target):
        raise ValueError(f"{path}: saved {node}, target {type(target).__name__} {target!r}")
    return node["value"]


def load_train_state(path: str, target, device: Optional[torch.device] = None, mesh=None):
    """The state saved at ``path``, checked against ``target`` (a tree of the
    same structure, e.g. a fresh state the same flags built): every
    container, key, length, tensor dtype and shape, and scalar type must
    match, or ``ValueError`` names the first difference.  Each tensor lands
    on ``device``, or where the target's tensor lies.  With ``mesh`` each
    rank reads its own shards of a state written on a mesh of the same
    sizes; any other mesh raises ``ValueError`` naming both."""
    with open(os.path.join(path, TREE_FILE)) as f:
        saved = json.load(f)
    fmt = saved.get("format")
    if fmt not in (FORMAT, SHARDED_FORMAT):
        raise ValueError(f"{path}: not a train state of this format ({fmt!r})")
    written = saved.get("mesh")
    this = None if mesh is None else _mesh_items(mesh)
    if written != this:
        where = lambda m: "one card (no mesh)" if m is None else ",".join(f"{k}{v}" for k, v in m)  # noqa: E731
        raise ValueError(f"{path}: written on mesh {where(written)}, this run is on mesh {where(this)}")
    if mesh is None:
        return _decode(saved["tree"], target, "", load_safetensors(os.path.join(path, TENSORS_FILE)), device)
    rank, world = dist.get_rank(), dist.get_world_size()
    if saved["world_size"] != world:
        raise ValueError(f"{path}: written by {saved['world_size']} ranks, this run has {world}")
    return _decode(saved["tree"], target, "", load_safetensors(os.path.join(path, rank_file(rank, world))), device)
