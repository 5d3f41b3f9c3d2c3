"""Tensor ops of the port, each the counterpart of the ``s2v_tpu.ops``
function of the same name (same layouts at the public boundary)."""
