"""Patch embedding as space-to-depth plus one linear
(counterpart of ``s2v_tpu/ops/patchify.py``).  Video latents are
channels-last ``[B, F, H, W, C]``."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def patchify_video(x: torch.Tensor, proj_weight: torch.Tensor, proj_bias: torch.Tensor, patch_size: int) -> torch.Tensor:
    """``[B, F, H, W, C] -> [B, F*(H/p)*(W/p), D]``.

    ``proj_weight``: ``[D, p*p*C]`` with input features in (ph, pw, c) order."""
    b, f, h, w, c = x.shape
    p = patch_size
    x = x.reshape(b, f, h // p, p, w // p, p, c)
    x = x.permute(0, 1, 2, 4, 3, 5, 6).reshape(b, f * (h // p) * (w // p), p * p * c)
    return F.linear(x, proj_weight, proj_bias)


def unpatchify_video(
    tokens: torch.Tensor, num_frames: int, height: int, width: int, patch_size: int, out_channels: int
) -> torch.Tensor:
    """``[B, S, p*p*Cout] -> [B, F, H, W, Cout]``; token features are
    (c, ph, pw)-ordered, as the ``proj_out`` rows are."""
    b = tokens.shape[0]
    p = patch_size
    x = tokens.reshape(b, num_frames, height // p, width // p, out_channels, p, p)
    x = x.permute(0, 1, 2, 5, 3, 6, 4)
    return x.reshape(b, num_frames, height, width, out_channels)
