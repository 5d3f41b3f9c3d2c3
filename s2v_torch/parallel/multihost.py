"""Process bootstrap (counterpart of ``s2v_tpu/parallel/multihost.py:27``
``initialize_distributed``).

JAX runs one controller process over every chip; PyTorch runs one process
per card, started by ``torchrun``, which sets ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK`` and ``MASTER_ADDR``/``MASTER_PORT``.  This makes the default
process group from that environment (NCCL on the card, each process on its
``LOCAL_RANK`` card; gloo on the CPU), or, without it, a group of one rank
over an in-process ``HashStore`` (no network).  ``make_hybrid_mesh``
(multi-host slices) is not ported (ROADMAP A.9).
"""

from __future__ import annotations

import os
from datetime import timedelta

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
