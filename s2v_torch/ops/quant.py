"""The format-dispatching dense layer of ``s2v_tpu/ops/quant.py``; the port
has the bf16/fp32 format only (int8 linears are later work)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def dense(params: dict, x: torch.Tensor) -> torch.Tensor:
    """``x @ weight.T + bias`` with ``weight`` ``[out, in]``, in x's dtype.

    An optional ``"lora"`` entry, a tuple of ``(a [in, r], b [r, out])``
    factor pairs with the alpha/r scale folded into ``a``, is applied after
    the linear: ``y += (x @ a) @ b``, both products in x's dtype."""
    y = F.linear(x, params["weight"], params.get("bias"))
    for a, b in params.get("lora", ()):
        y = y + ((x @ a.to(x.dtype)) @ b.to(x.dtype)).to(y.dtype)
    return y
