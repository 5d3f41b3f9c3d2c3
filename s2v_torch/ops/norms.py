"""Normalization with fp32 statistics whatever the input dtype.

Counterpart of ``s2v_tpu/ops/norms.py``: statistics in fp32, the elementwise
apply of ``layer_norm`` in the input dtype (as the JAX package does), the
apply of ``rms_norm`` and ``group_norm`` in fp32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def layer_norm(x: torch.Tensor, weight=None, bias=None, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis; fp32 stats, input-dtype apply."""
    dt = x.dtype
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    rstd = torch.reciprocal(torch.sqrt(var + eps))
    out = (x - mean.to(dt)) * rstd.to(dt)
    if weight is not None:
        out = out * weight.to(dt)
    if bias is not None:
        out = out + bias.to(dt)
    return out


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """T5-style RMSNorm (no mean subtraction); fp32 stats."""
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    out = xf * torch.reciprocal(torch.sqrt(var + eps))
    return (out * weight.float()).to(x.dtype)


def group_norm(x: torch.Tensor, weight, bias, num_groups: int, eps: float = 1e-6) -> torch.Tensor:
    """GroupNorm of a channels-first ``[B, C, *spatial]`` tensor, fp32 math.

    The JAX function takes channels-last video; the port's VAE runs
    channels-first (NCDHW) throughout, so this one does too."""
    out = F.group_norm(x.float(), num_groups, weight.float(), bias.float(), eps)
    return out.to(x.dtype)
