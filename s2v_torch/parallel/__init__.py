"""Multi-GPU pieces of the port (counterpart of ``s2v_tpu/parallel``): the
mesh context and the sequence-parallel windowed attention ``sp_windowed``.
The rest of ``s2v_tpu/parallel`` (TP/FSDP sharding, AG-KV, Ulysses, ring
attention, the context-parallel VAE) is not ported yet."""

from s2v_torch.parallel.context import active_axis, active_mesh, default_logical_map, mesh_context

__all__ = ["active_axis", "active_mesh", "default_logical_map", "mesh_context"]
