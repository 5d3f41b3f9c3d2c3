"""Logical-axis mesh context (counterpart of ``s2v_tpu/parallel/context.py``).

Model code asks :func:`active_mesh` and :func:`active_axis` for the mesh and
the name of the mesh dimension a *logical* axis (``"dp"``/``"sp"``/``"tp"``)
is mapped to; outside a :func:`mesh_context` both are None, so single-card
paths run unchanged.  The mesh is a
``torch.distributed.device_mesh.DeviceMesh`` whose dims carry names, as a
``jax.sharding.Mesh``'s axes do; its process group must already be
initialised (``torch.distributed.init_process_group``).  Only the
``"sp"`` -> ``"seq"`` mapping is used so far (the ``sp_windowed`` attention
backend).

``constrain`` is not ported: it is ``with_sharding_constraint`` for GSPMD,
which PyTorch has no counterpart of.  Outside attention the port keeps every
activation whole on every rank (replicated), as the JAX package does on one
chip; the sequence-parallel wrappers shard and gather inside attention.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional

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
