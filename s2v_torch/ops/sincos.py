"""3D sincos absolute positional embeddings of the 2b family (counterpart of
``s2v_tpu/ops/sincos.py``, a copy of its numpy code).

``get_3d_sincos_pos_embed`` builds the table from 1D sin | cos tables:
temporal D/4 then spatial 3D/4, on a w-major grid; the joint table is zero
over the text span and the 3D table over the video tokens.  Host-side numpy
in float64 with a float32 result; the table is fixed per (h, w, frames,
text length).
"""

from __future__ import annotations

from typing import Tuple, Union

import numpy as np


def get_1d_sincos_pos_embed_from_grid(embed_dim: int, pos: np.ndarray) -> np.ndarray:
    if embed_dim % 2 != 0:
        raise ValueError("embed_dim must be divisible by 2")
    omega = np.arange(embed_dim // 2, dtype=np.float64)
    omega /= embed_dim / 2.0
    omega = 1.0 / 10000**omega
    out = np.einsum("m,d->md", pos.reshape(-1), omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


def get_3d_sincos_pos_embed(
    embed_dim: int,
    spatial_size: Union[int, Tuple[int, int]],
    temporal_size: int,
    spatial_interpolation_scale: float = 1.0,
    temporal_interpolation_scale: float = 1.0,
) -> np.ndarray:
    """-> ``[T, H*W, D]``; ``spatial_size`` is (W, H), the grid w-major."""
    if embed_dim % 4 != 0:
        raise ValueError("embed_dim must be divisible by 4")
    if isinstance(spatial_size, int):
        spatial_size = (spatial_size, spatial_size)
    dim_spatial = 3 * embed_dim // 4
    dim_temporal = embed_dim // 4

    grid_h = np.arange(spatial_size[1], dtype=np.float32) / spatial_interpolation_scale
    grid_w = np.arange(spatial_size[0], dtype=np.float32) / spatial_interpolation_scale
    gw, gh = np.meshgrid(grid_w, grid_h)  # w goes first
    emb_h = get_1d_sincos_pos_embed_from_grid(dim_spatial // 2, gw)
    emb_w = get_1d_sincos_pos_embed_from_grid(dim_spatial // 2, gh)
    pos_spatial = np.concatenate([emb_h, emb_w], axis=1)  # [H*W, 3D/4]

    grid_t = np.arange(temporal_size, dtype=np.float32) / temporal_interpolation_scale
    pos_temporal = get_1d_sincos_pos_embed_from_grid(dim_temporal, grid_t)  # [T, D/4]

    pos_spatial = np.repeat(pos_spatial[np.newaxis], temporal_size, axis=0)
    pos_temporal = np.repeat(pos_temporal[:, np.newaxis], spatial_size[0] * spatial_size[1], axis=1)
    return np.concatenate([pos_temporal, pos_spatial], axis=-1)  # [T, H*W, D]


def joint_text_video_pos_embedding(
    embed_dim: int,
    sample_height: int,
    sample_width: int,
    sample_frames: int,
    patch_size: int,
    temporal_compression_ratio: int,
    text_seq_length: int,
    spatial_interpolation_scale: float = 1.875,
    temporal_interpolation_scale: float = 1.0,
) -> np.ndarray:
    """``[text_len + T·H'·W', D]`` float32: zeros over the text span, the 3D
    sincos table over the video tokens.  ``sample_height``/``sample_width``
    are latent pixels, ``sample_frames`` pixel frames."""
    hp = sample_height // patch_size
    wp = sample_width // patch_size
    t = (sample_frames - 1) // temporal_compression_ratio + 1
    pos = get_3d_sincos_pos_embed(
        embed_dim, (wp, hp), t, spatial_interpolation_scale, temporal_interpolation_scale
    ).reshape(t * hp * wp, embed_dim)
    out = np.zeros((text_seq_length + pos.shape[0], embed_dim), np.float32)
    out[text_seq_length:] = pos
    return out
