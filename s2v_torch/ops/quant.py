"""The format-dispatching dense layer of ``s2v_tpu/ops/quant.py``; the port
has the bf16/fp32 format only (int8 linears and attached LoRA factors are
later work)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def dense(params: dict, x: torch.Tensor) -> torch.Tensor:
    """``x @ weight.T + bias`` with ``weight`` ``[out, in]``, in x's dtype."""
    return F.linear(x, params["weight"], params.get("bias"))
