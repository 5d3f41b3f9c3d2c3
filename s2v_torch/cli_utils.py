"""Shared argparse coercers and choices of the port's entry points
(counterpart of ``s2v_tpu/cli_utils.py``).

The JAX module's compilation-cache and backend-probe helpers configure the
JAX runtime and have no counterpart here.  The attention backend choices are
the JAX package's names, so a command line of the reference CLI parses;
:data:`BACKEND_NAMES` maps them to the port's backends.
"""

from __future__ import annotations

from s2v_torch.ops.attention import SEQ_BACKENDS

# the JAX CLI's --attention_backend choices (s2v_tpu/ops/attention.py:30-37)
ATTENTION_BACKEND_CHOICES = [
    "auto", "xla", "pallas", "pallas_int8", "chunked", "ring", "sp_allgather", "sp_int8", "sp_ulysses",
    "windowed", "windowed_gather", "windowed_xla", "sp_windowed",
]
# JAX name -> the port's backend (s2v_torch/ops/attention.py)
BACKEND_NAMES = {
    "auto": "auto", "pallas": "flash", "pallas_int8": "flash_int8", "xla": "plain", "chunked": "chunked",
    "windowed": "windowed", "windowed_gather": "windowed_gather", "windowed_xla": "windowed_plain",
    "ring": "ring", "sp_allgather": "sp_allgather", "sp_int8": "sp_int8", "sp_ulysses": "sp_ulysses",
    "sp_windowed": "sp_windowed",
}
# the JAX names of the backends that run over a seq mesh
SEQ_BACKEND_NAMES = tuple(jax_name for jax_name, port in BACKEND_NAMES.items() if port in SEQ_BACKENDS)


def check_mesh_flags(args) -> None:
    """Before anything loads: a ``--mesh`` that does not parse,
    ``--text_encoder_device mesh`` without ``--mesh``, or a
    sequence-parallel backend without ``--mesh``, raises ``ValueError``."""
    if args.mesh is not None:
        from s2v_torch.parallel.sharding import parse_mesh_spec

        parse_mesh_spec(args.mesh)
    if args.text_encoder_device == "mesh" and args.mesh is None:
        raise ValueError("--text_encoder_device mesh needs --mesh (e.g. tp2, or tp1 on one card)")
    if args.attention_backend in SEQ_BACKEND_NAMES and args.mesh is None:
        raise ValueError(f"--attention_backend {args.attention_backend} needs --mesh sp<N> (sp1 on one card)")


def str2bool(v):
    if isinstance(v, bool):
        return v
    if str(v).lower() in ("true", "1", "yes", "y"):
        return True
    if str(v).lower() in ("false", "0", "no", "n"):
        return False
    raise ValueError(f"expected a boolean, got {v!r}")


def tiling_policy(v):
    """--enable_tiling: true | false | auto (tile above native size)."""
    if str(v).lower() == "auto":
        return "auto"
    return str2bool(v)
