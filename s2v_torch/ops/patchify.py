"""Patch embedding as space-to-depth plus one linear
(counterpart of ``s2v_tpu/ops/patchify.py``).  Video latents are
channels-last ``[B, F, H, W, C]``.

With ``patch_size_t`` (CogVideoX1.5) a token is a ``pₜ x p x p`` patch over
(time, height, width): tokens in (t, h, w) order, features in
(c, pₜ, ph, pw) order, as diffusers' ``CogVideoXPatchEmbed`` and
``proj_out`` lay them out.  Without it a token is one frame's ``p x p``
patch, features in (ph, pw, c) order."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def patchify_video(x: torch.Tensor, proj_weight: torch.Tensor, proj_bias: Optional[torch.Tensor], patch_size: int,
                   patch_size_t: Optional[int] = None) -> torch.Tensor:
    """``[B, F, H, W, C] -> [B, (F/pₜ)*(H/p)*(W/p), D]``.

    ``proj_weight``: ``[D, p*p*C]`` with input features in (ph, pw, c) order,
    or with ``patch_size_t`` ``[D, C*pₜ*p*p]`` in (c, pₜ, ph, pw) order;
    ``proj_bias`` may be None."""
    b, f, h, w, c = x.shape
    p = patch_size
    if patch_size_t is None:
        x = x.reshape(b, f, h // p, p, w // p, p, c)
        x = x.permute(0, 1, 2, 4, 3, 5, 6).reshape(b, f * (h // p) * (w // p), p * p * c)
    else:
        pt = patch_size_t
        if f % pt:
            raise ValueError(f"{f} latent frames do not split into temporal patches of {pt} (patch_size_t)")
        x = x.reshape(b, f // pt, pt, h // p, p, w // p, p, c)
        x = x.permute(0, 1, 3, 5, 7, 2, 4, 6).reshape(b, (f // pt) * (h // p) * (w // p), c * pt * p * p)
    return F.linear(x, proj_weight, proj_bias)


def unpatchify_video(
    tokens: torch.Tensor, num_frames: int, height: int, width: int, patch_size: int, out_channels: int,
    patch_size_t: Optional[int] = None,
) -> torch.Tensor:
    """``[B, S, p*p*Cout] -> [B, F, H, W, Cout]``; token features are
    (c, ph, pw)-ordered, as the ``proj_out`` rows are, or with
    ``patch_size_t`` ``[B, S, Cout*pₜ*p*p]`` (c, pₜ, ph, pw)-ordered."""
    b = tokens.shape[0]
    p = patch_size
    if patch_size_t is None:
        x = tokens.reshape(b, num_frames, height // p, width // p, out_channels, p, p)
        x = x.permute(0, 1, 2, 5, 3, 6, 4)
    else:
        pt = patch_size_t
        x = tokens.reshape(b, num_frames // pt, height // p, width // p, out_channels, pt, p, p)
        x = x.permute(0, 1, 5, 2, 6, 3, 7, 4)
    return x.reshape(b, num_frames, height, width, out_channels)
