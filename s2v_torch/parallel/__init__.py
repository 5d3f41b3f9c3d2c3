"""Multi-card pieces of the port (counterpart of ``s2v_tpu/parallel``): mesh
specs, meshes and parameter placements for megatron TP and FSDP
(``sharding.py``), process groups (``multihost.py``), the mesh context, the
frame shards and the collectives of the data and model dims
(``context.py``), the sequence-parallel attention backends
(``sp_attention.py``, ``ring_attention.py``), the context-parallel VAE
over frames (``vae_temporal.py``) and over spatial tiles
(``vae_spatial.py``), and meshes across hosts (``multihost.py``:
``make_hybrid_mesh``)."""

from s2v_torch.parallel.context import (
    FrameShard,
    active_axis,
    active_mesh,
    default_logical_map,
    frame_shard,
    gather_video,
    mesh_context,
    sum_grads_over_seq,
)
from s2v_torch.parallel.multihost import initialize_distributed, make_hybrid_mesh

__all__ = ["FrameShard", "active_axis", "active_mesh", "default_logical_map", "frame_shard", "gather_video",
           "initialize_distributed", "make_hybrid_mesh", "mesh_context", "sum_grads_over_seq"]
