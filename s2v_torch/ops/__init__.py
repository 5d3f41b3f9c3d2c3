"""Tensor ops of the port, each the counterpart of the ``s2v_tpu.ops``
function of the same name (same layouts at the public boundary)."""

from s2v_torch.ops.quant import dense, int8_dense, quantize_transformer_params, quantize_weight_int8  # noqa: F401
