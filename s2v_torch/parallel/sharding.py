"""Mesh specs and meshes (counterpart of ``s2v_tpu/parallel/sharding.py``:
``parse_mesh_spec`` :130, ``make_mesh`` :29).

The grammar is JAX's whole (``"sp8"``, ``"seq8"``, ``"dp2,tp4"``, or a dict
of sizes), so error texts name the same axes.  The port builds a
``torch.distributed.device_mesh.DeviceMesh`` for a spec that has only a
``seq`` dim: a ``data`` or ``model`` dim is TP/FSDP or data parallelism,
not ported yet (ROADMAP A.9), and so are ``transformer_param_specs`` and
``shard_params``.  The params stay whole on every rank.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional, Union

# logical and mesh names of the axes (s2v_tpu/parallel/sharding.py:139-140)
_ALIAS = {"dp": "data", "tp": "model", "sp": "seq", "data": "data", "model": "model", "seq": "seq"}


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


def seq_mesh_size(spec: Union[str, Dict[str, int]]) -> int:
    """The ``seq`` ring of a spec (a string or a dict of sizes); a ``data``
    or ``model`` dim raises ``NotImplementedError`` naming ROADMAP A.9."""
    sizes = parse_mesh_spec(spec) if isinstance(spec, str) else {_ALIAS.get(k, k): int(v) for k, v in spec.items()}
    other = {k: v for k, v in sizes.items() if k != "seq"}
    if other:
        raise NotImplementedError(f"mesh {sizes}: data and model dims (data parallelism, TP/FSDP) are not ported "
                                  f"yet (ROADMAP A.9); the port takes a seq-only mesh such as 'sp4'")
    if "seq" not in sizes:
        raise ValueError(f"mesh {sizes} has no seq dim")
    return sizes["seq"]


def make_mesh(spec: Union[str, Dict[str, int]], device_type: str):
    """A one-dim ``seq`` ``DeviceMesh`` of the spec's size over the default
    process group, which :func:`s2v_torch.parallel.multihost.initialize_distributed`
    makes when it is not there yet.  Its size must be the world size."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from s2v_torch.parallel.multihost import initialize_distributed

    ring = seq_mesh_size(spec)
    initialize_distributed(device_type)
    world = dist.get_world_size()
    if ring != world:
        raise ValueError(f"mesh {spec!r} has {ring} ranks but the process group has {world} (start one process "
                         f"per card: torchrun --nproc_per_node {ring})")
    return init_device_mesh(device_type, (ring,), mesh_dim_names=("seq",))


@contextlib.contextmanager
def entry_point_mesh(spec: Optional[str], device_type: str):
    """An entry point's ``--mesh``: the mesh of the spec (None without one),
    and the default process group, if this made it, destroyed on exit."""
    import torch.distributed as dist

    if spec is None:
        yield None
        return
    made = not dist.is_initialized()
    try:
        yield make_mesh(spec, device_type)
    finally:
        if made and dist.is_initialized():
            dist.destroy_process_group()
