"""Sinusoidal timestep embedding and the conditioning MLP
(counterpart of ``s2v_tpu/ops/timestep.py``)."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def get_timestep_embedding(
    timesteps: torch.Tensor,
    embedding_dim: int,
    flip_sin_to_cos: bool = True,
    downscale_freq_shift: float = 0.0,
    scale: float = 1.0,
    max_period: int = 10000,
) -> torch.Tensor:
    """``[N] -> [N, embedding_dim]`` fp32 sinusoid (cos|sin when flipped)."""
    half_dim = embedding_dim // 2
    exponent = -math.log(max_period) * torch.arange(half_dim, dtype=torch.float32, device=timesteps.device)
    exponent = exponent / (half_dim - downscale_freq_shift)
    emb = timesteps.float()[:, None] * torch.exp(exponent)[None, :]
    emb = scale * emb
    emb = torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)
    if flip_sin_to_cos:
        emb = torch.cat([emb[:, half_dim:], emb[:, :half_dim]], dim=-1)
    if embedding_dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


def timestep_embedding_mlp(params: dict, sample: torch.Tensor) -> torch.Tensor:
    """linear -> silu -> linear."""
    x = F.linear(sample, params["linear_1"]["weight"], params["linear_1"]["bias"])
    x = F.silu(x)
    return F.linear(x, params["linear_2"]["weight"], params["linear_2"]["bias"])
