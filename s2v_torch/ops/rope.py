"""3D rotary position embeddings (counterpart of ``s2v_tpu/ops/rope.py``).

The tables are host numpy, as in the JAX package, stored non-interleaved as
``[S, D/2]`` cos/sin; pair ``i`` rotates channels ``(2i, 2i+1)``.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from s2v_torch.utils.logging import phase


def get_resize_crop_region_for_grid(src_hw, tgt_width, tgt_height):
    """Center-crop coordinates used to align RoPE grids across aspect ratios."""
    h, w = src_hw
    if h / w > tgt_height / tgt_width:
        resize_height = tgt_height
        resize_width = int(round(tgt_height / h * w))
    else:
        resize_width = tgt_width
        resize_height = int(round(tgt_width / w * h))
    crop_top = int(round((tgt_height - resize_height) / 2.0))
    crop_left = int(round((tgt_width - resize_width) / 2.0))
    return (crop_top, crop_left), (crop_top + resize_height, crop_left + resize_width)


def get_1d_rotary_freqs(dim: int, pos: np.ndarray, theta: float = 10000.0) -> Tuple[np.ndarray, np.ndarray]:
    """cos/sin tables of shape ``[len(pos), dim/2]``."""
    if dim % 2:
        raise ValueError(f"rotary dim must be even, got {dim}")
    inv_freq = 1.0 / (theta ** (np.arange(0, dim, 2, dtype=np.float32) / dim))
    angles = np.outer(pos.astype(np.float32), inv_freq)
    return np.cos(angles), np.sin(angles)


def get_3d_rotary_pos_embed(
    embed_dim: int,
    crops_coords,
    grid_size: Tuple[int, int],
    temporal_size: int,
    theta: float = 10000.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """RoPE over a (T, H, W) token grid: (cos, sin), each ``[T*H*W, D/2]``.
    Axis split: temporal D/4, height 3D/8, width 3D/8 channels."""
    (start_h, start_w), (stop_h, stop_w) = crops_coords
    grid_h_n, grid_w_n = grid_size
    grid_h = start_h + (stop_h - start_h) * np.arange(grid_h_n, dtype=np.float32) / grid_h_n
    grid_w = start_w + (stop_w - start_w) * np.arange(grid_w_n, dtype=np.float32) / grid_w_n
    grid_t = np.arange(temporal_size, dtype=np.float32)

    dim_t = embed_dim // 4
    dim_h = embed_dim // 8 * 3
    dim_w = embed_dim // 8 * 3
    cos_t, sin_t = get_1d_rotary_freqs(dim_t, grid_t, theta)
    cos_h, sin_h = get_1d_rotary_freqs(dim_h, grid_h, theta)
    cos_w, sin_w = get_1d_rotary_freqs(dim_w, grid_w, theta)

    def combine(ft, fh, fw):
        t, h, w = temporal_size, grid_h_n, grid_w_n
        ft = np.broadcast_to(ft[:, None, None, :], (t, h, w, ft.shape[-1]))
        fh = np.broadcast_to(fh[None, :, None, :], (t, h, w, fh.shape[-1]))
        fw = np.broadcast_to(fw[None, None, :, :], (t, h, w, fw.shape[-1]))
        return np.concatenate([ft, fh, fw], axis=-1).reshape(t * h * w, -1)

    return combine(cos_t, cos_h, cos_w), combine(sin_t, sin_h, sin_w)


def prepare_video_and_ref_rope(
    height: int,
    width: int,
    num_latent_frames: int,
    attention_head_dim: int,
    patch_size: int = 2,
    vae_spatial_ratio: int = 8,
    base_height: int = 480,
    base_width: int = 720,
):
    """(video_cos, video_sin, ref_cos, ref_sin): the subject image is frame 0
    of a ``num_latent_frames + 1`` frame table, the video frames 1..F."""
    grid_h = height // (vae_spatial_ratio * patch_size)
    grid_w = width // (vae_spatial_ratio * patch_size)
    base_h = base_height // (vae_spatial_ratio * patch_size)
    base_w = base_width // (vae_spatial_ratio * patch_size)
    crops = get_resize_crop_region_for_grid((grid_h, grid_w), base_w, base_h)
    cos, sin = get_3d_rotary_pos_embed(attention_head_dim, crops, (grid_h, grid_w), num_latent_frames + 1)
    tpf = grid_h * grid_w
    return cos[tpf:], sin[tpf:], cos[:tpf], sin[:tpf]


def build_segmented_rope(
    text_len: int,
    ref_cos: np.ndarray,
    ref_sin: np.ndarray,
    vid_cos: np.ndarray,
    vid_sin: np.ndarray,
    device: Optional[Union[str, torch.device]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One fp32 (cos, sin) table over ``[text | ref | video]``; the text span
    gets the identity rotation."""
    half = ref_cos.shape[-1]
    cos = np.concatenate([np.ones((text_len, half), np.float32), ref_cos, vid_cos], axis=0)
    sin = np.concatenate([np.zeros((text_len, half), np.float32), ref_sin, vid_sin], axis=0)
    cos, sin = (torch.from_numpy(np.ascontiguousarray(t, np.float32)) for t in (cos, sin))
    with phase("s2v.sync.to_device"):  # copies from the host
        return cos.to(device), sin.to(device)


def apply_rotary_emb(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate channel pairs of ``x`` ``[..., S, D]`` by ``[S, D/2]`` tables
    (broadcastable); fp32 math, x's dtype out."""
    xf = x.float().unflatten(-1, (-1, 2))
    x_even, x_odd = xf[..., 0], xf[..., 1]
    cos = cos.float()
    sin = sin.float()
    out = torch.stack([x_even * cos - x_odd * sin, x_odd * cos + x_even * sin], dim=-1)
    return out.flatten(-2).to(x.dtype)
