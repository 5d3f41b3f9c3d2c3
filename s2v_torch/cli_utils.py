"""Shared argparse coercers and choices of the port's entry points
(counterpart of ``s2v_tpu/cli_utils.py``).

The JAX module's compilation-cache and backend-probe helpers configure the
JAX runtime and have no counterpart here.  The attention backend choices are
the JAX package's names, so a command line of the reference CLI parses;
:data:`BACKEND_NAMES` maps them to the port's backends.
"""

from __future__ import annotations

# the JAX CLI's --attention_backend choices (s2v_tpu/ops/attention.py:30-37)
ATTENTION_BACKEND_CHOICES = [
    "auto", "xla", "pallas", "pallas_int8", "chunked", "ring", "sp_allgather", "sp_int8", "sp_ulysses",
    "windowed", "windowed_gather", "windowed_xla", "sp_windowed",
]
# JAX name -> the port's backend (s2v_torch/ops/attention.py)
BACKEND_NAMES = {
    "auto": "auto", "pallas": "flash", "pallas_int8": "flash_int8", "xla": "plain", "chunked": "chunked",
    "windowed": "windowed", "windowed_gather": "windowed_gather", "windowed_xla": "windowed_plain",
}
# JAX names with no port backend yet -> the ROADMAP item that ports them
UNPORTED_BACKENDS = {"ring": "A.9", "sp_allgather": "A.9", "sp_int8": "A.9",
                     "sp_ulysses": "A.9", "sp_windowed": "A.9"}


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
