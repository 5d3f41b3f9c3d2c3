"""Multi-card pieces of the port (counterpart of ``s2v_tpu/parallel``): mesh
specs and process groups (``sharding.py``, ``multihost.py``), the mesh
context and frame shards (``context.py``), the sequence-parallel attention
backends (``sp_attention.py``, ``ring_attention.py``) and the
context-parallel VAE (``vae_temporal.py``).  TP/FSDP sharding, the spatial
CP decode and multi-host meshes are not ported (ROADMAP A.9)."""

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
