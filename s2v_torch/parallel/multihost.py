"""Process bootstrap (counterpart of ``s2v_tpu/parallel/multihost.py:27``
``initialize_distributed``).

JAX runs one controller process over every chip; PyTorch runs one process
per card, started by ``torchrun``, which sets ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK`` and ``MASTER_ADDR``/``MASTER_PORT``.  This makes the default
process group from that environment (NCCL on the card, each process on its
``LOCAL_RANK`` card; gloo on the CPU), or, without it, a group of one rank
over an in-process ``HashStore`` (no network).  :func:`make_hybrid_mesh`
names the cross-host dims of a mesh over several hosts.
"""

from __future__ import annotations

import math
import os
from datetime import timedelta
from typing import Dict

# how long a collective may wait before the group fails it
COLLECTIVE_TIMEOUT = timedelta(minutes=10)


def launched_by_torchrun() -> bool:
    return all(k in os.environ for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"))


def initialize_distributed(device_type: str = "cuda") -> bool:
    """Initialise the default process group unless one exists; returns True
    when this call made it.  On the card each process first selects its
    ``LOCAL_RANK`` card."""
    import torch
    import torch.distributed as dist

    if dist.is_initialized():
        return False
    backend = "nccl" if device_type == "cuda" else "gloo"
    if device_type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    if launched_by_torchrun():
        dist.init_process_group(backend, init_method="env://", timeout=COLLECTIVE_TIMEOUT)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1, timeout=COLLECTIVE_TIMEOUT)
    return True


def is_main_process() -> bool:
    """Rank 0 of the default group, or the only process."""
    import torch.distributed as dist

    return not dist.is_initialized() or dist.get_rank() == 0


def make_hybrid_mesh(dcn_axes: Dict[str, int], ici_axes: Dict[str, int], device_type: str = "cuda"):
    """A ``DeviceMesh`` with named cross-host (DCN) dims outermost and
    within-host (ICI) dims inside, e.g. ``make_hybrid_mesh({"data": 2},
    {"model": 4})`` (``s2v_tpu/parallel/multihost.py:55``).

    ``torchrun`` numbers ranks node-major (rank = node · LOCAL_WORLD_SIZE +
    local rank), and the mesh lays the ranks out row-major, so each host's
    ranks fill the inner dims and its collectives over them stay on its
    NVLink.  Across hosts the DCN dims' product must be the number of hosts
    (WORLD_SIZE / LOCAL_WORLD_SIZE).  On one host the same named layout:
    the DCN dims are plain outer dims, as in JAX's single-process branch.
    The sizes' product must be the world size."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    names = list(dcn_axes) + list(ici_axes)
    if len(set(names)) != len(names):
        raise ValueError(f"the DCN dims {list(dcn_axes)} and ICI dims {list(ici_axes)} must have distinct names")
    shape = [dcn_axes[n] for n in dcn_axes] + [ici_axes[n] for n in ici_axes]
    initialize_distributed(device_type)
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"mesh wants {math.prod(shape)} devices, have {world}")
    hosts = world // int(os.environ.get("LOCAL_WORLD_SIZE", world))
    dcn_total = math.prod(dcn_axes.values())
    if hosts > 1 and dcn_total != hosts:
        raise ValueError(f"DCN axes {dcn_axes} (product {dcn_total}) do not match the host count ({hosts}); size "
                         f"the outer axes to the hosts")
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(names))
