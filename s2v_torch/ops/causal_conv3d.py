"""Causal 3D convolution with a streaming conv cache
(counterpart of ``s2v_tpu/ops/causal_conv3d.py``).

The port's VAE runs channels-first: activations ``[B, C, T, H, W]`` and
kernels ``[Cout, Cin, kt, kh, kw]`` (converted once at load time), the
layouts cuDNN takes without a per-layer transpose.  The temporal padding is
the cached last ``kt - 1`` frames of the previous chunk, or a replication of
the first frame for the first chunk; the spatial padding is zeros.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def causal_conv3d(
    params: dict,
    x: torch.Tensor,
    cache: Optional[torch.Tensor] = None,
    time_stride: int = 1,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Returns (output, new_cache).  ``x`` ``[B, Cin, T, H, W]``; ``cache``
    ``[B, Cin, kt-1, H, W]`` from the previous chunk, or None."""
    w = params["weight"]
    kt, kh, kw = w.shape[2], w.shape[3], w.shape[4]
    new_cache = None
    if kt > 1:
        pad = x[:, :, :1].expand(-1, -1, kt - 1, -1, -1) if cache is None else cache.to(x.dtype)
        x = torch.cat([pad, x], dim=2)
        new_cache = x[:, :, -(kt - 1):].clone()  # a copy, so the padded input can be freed
    out = F.conv3d(x, w.to(x.dtype), params["bias"].to(x.dtype), stride=(time_stride, 1, 1),
                   padding=(0, kh // 2, kw // 2))
    return out, new_cache


def conv1x1x1(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Pointwise 3D conv (``weight`` ``[Cout, Cin, 1, 1, 1]``)."""
    return F.conv3d(x, params["weight"].to(x.dtype), params["bias"].to(x.dtype))


def conv2d_per_frame(params: dict, x: torch.Tensor, stride: int = 1, padding: int = 1) -> torch.Tensor:
    """2D conv applied frame by frame to ``[B, C, T, H, W]`` (``weight``
    ``[Cout, Cin, kh, kw]``, symmetric zero ``padding``): a 3D conv with a
    temporal extent of 1, so the frames need no relayout."""
    w = params["weight"].to(x.dtype).unsqueeze(2)
    return F.conv3d(x, w, params["bias"].to(x.dtype), stride=(1, stride, stride), padding=(0, padding, padding))


def nearest_resize_video(x: torch.Tensor, size_thw: Tuple[int, int, int]) -> torch.Tensor:
    """Nearest-neighbour resize of ``[B, C, T, H, W]`` to (T', H', W') with
    torch ``F.interpolate(mode='nearest')`` index semantics floor(i·in/out)."""
    t, h, w = x.shape[2:]
    tt, th, tw = size_thw
    dev = x.device
    idx_t = torch.arange(tt, device=dev) * t // tt
    idx_h = torch.arange(th, device=dev) * h // th
    idx_w = torch.arange(tw, device=dev) * w // tw
    return x.index_select(2, idx_t).index_select(3, idx_h).index_select(4, idx_w)
