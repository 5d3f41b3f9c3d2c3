"""Multi-card pieces of the port (counterpart of ``s2v_tpu/parallel``): mesh
specs, meshes and parameter placements for megatron TP and FSDP
(``sharding.py``), process groups (``multihost.py``), the mesh context, the
frame shards and the collectives of the data and model dims
(``context.py``), the sequence-parallel attention backends
(``sp_attention.py``, ``ring_attention.py``) and the context-parallel VAE
(``vae_temporal.py``).  The spatial CP decode and multi-host meshes are not
ported (ROADMAP A.9)."""

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

__all__ = ["FrameShard", "active_axis", "active_mesh", "default_logical_map", "frame_shard", "gather_video",
           "mesh_context", "sum_grads_over_seq"]
