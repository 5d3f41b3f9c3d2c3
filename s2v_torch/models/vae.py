"""3D causal KL-VAE of CogVideoX (counterpart of ``s2v_tpu/models/vae.py``).

The public functions ``vae_encode`` / ``vae_decode`` take and return the JAX
package's channels-last video ``[B, T, H, W, C]``; everything inside runs
channels-first ``[B, C, T, H, W]`` with ``OIDHW`` / ``OIHW`` kernels, one
transpose at each end.  Frame-chunk streaming with conv caches follows the
reference schedule (remainder folded into the first chunk); tiling blends
overlapping tiles as the reference does.
"""

from __future__ import annotations

from typing import Optional, Union

import torch
import torch.nn.functional as F

from s2v_torch.config import VAEConfig
from s2v_torch.ops.causal_conv3d import causal_conv3d, conv1x1x1, conv2d_per_frame, nearest_resize_video
from s2v_torch.ops.norms import group_norm
from s2v_torch.utils.device import resolve_device

_TEMPORAL_LEVELS = 2  # log2(temporal_compression_ratio)


def spatial_norm3d(params: dict, f: torch.Tensor, zq: torch.Tensor, num_groups: int) -> torch.Tensor:
    """GroupNorm(f) modulated by 1x1x1 convs of z, resized to f's (T, H, W);
    an odd frame count > 1 resizes the first frame on its own."""
    ft, fh, fw = f.shape[2:]
    if ft > 1 and ft % 2 == 1:
        z_first = nearest_resize_video(zq[:, :, :1], (1, fh, fw))
        z_rest = nearest_resize_video(zq[:, :, 1:], (ft - 1, fh, fw))
        zq = torch.cat([z_first, z_rest], dim=2)
    else:
        zq = nearest_resize_video(zq, (ft, fh, fw))
    norm_f = group_norm(f, params["norm"]["weight"], params["norm"]["bias"], num_groups)
    return norm_f * conv1x1x1(params["conv_y"], zq) + conv1x1x1(params["conv_b"], zq)


def _norm(params: dict, x: torch.Tensor, zq, num_groups: int) -> torch.Tensor:
    if "conv_y" in params:
        return spatial_norm3d(params, x, zq, num_groups)
    return group_norm(x, params["weight"], params["bias"], num_groups)


def resnet3d(params: dict, x: torch.Tensor, zq, cache: Optional[dict], num_groups: int):
    """CogVideoXResnetBlock3D without temb; returns (out, new_cache)."""
    cache = cache or {}
    new_cache = {}
    h = F.silu(_norm(params["norm1"], x, zq, num_groups))
    h, new_cache["conv1"] = causal_conv3d(params["conv1"], h, cache.get("conv1"))
    h = F.silu(_norm(params["norm2"], h, zq, num_groups))
    h, new_cache["conv2"] = causal_conv3d(params["conv2"], h, cache.get("conv2"))
    if "conv_shortcut" in params:
        x = conv1x1x1(params["conv_shortcut"], x)
    return h + x, new_cache


def downsample3d(params: dict, x: torch.Tensor, compress_time: bool) -> torch.Tensor:
    """Optional temporal average pool (frame 0 kept when odd), zero pad right
    and bottom, stride-2 conv per frame."""
    if compress_time:
        if x.shape[2] % 2 == 1:
            first, rest = x[:, :, :1], x[:, :, 1:]
            if rest.shape[2] > 0:
                rest = 0.5 * (rest[:, :, 0::2] + rest[:, :, 1::2])
            x = torch.cat([first, rest], dim=2)
        else:
            x = 0.5 * (x[:, :, 0::2] + x[:, :, 1::2])
    x = F.pad(x, (0, 1, 0, 1))
    return conv2d_per_frame(params["conv"], x, stride=2, padding=0)


def upsample3d(params: dict, x: torch.Tensor, compress_time: bool) -> torch.Tensor:
    """Nearest 2x upsampling (temporal too when ``compress_time``, frame 0
    kept single when odd) and a 3x3 conv per frame."""
    t = x.shape[2]
    if compress_time and t > 1 and t % 2 == 1:
        first = F.interpolate(x[:, :, :1], scale_factor=(1, 2, 2), mode="nearest")
        rest = F.interpolate(x[:, :, 1:], scale_factor=(2, 2, 2), mode="nearest")
        x = torch.cat([first, rest], dim=2)
    elif compress_time and t > 1:
        x = F.interpolate(x, scale_factor=(2, 2, 2), mode="nearest")
    else:
        x = F.interpolate(x, scale_factor=(1, 2, 2), mode="nearest")
    return conv2d_per_frame(params["conv"], x, stride=1, padding=1)


def _resnet_stack(resnets, x, zq, cache, num_groups):
    cache = cache or {}
    new_cache = {}
    for i, rp in enumerate(resnets):
        key = f"resnet_{i}"
        x, new_cache[key] = resnet3d(rp, x, zq, cache.get(key), num_groups)
    return x, new_cache


def encoder_forward(params: dict, cfg: VAEConfig, x: torch.Tensor, cache=None):
    """``[B, 3, T, H, W]`` -> (``[B, 2*latent, T', H/8, W/8]``, new_cache)."""
    cache = cache or {}
    new_cache = {}
    g = cfg.norm_num_groups
    h, new_cache["conv_in"] = causal_conv3d(params["conv_in"], x, cache.get("conv_in"))
    for i, block in enumerate(params["down_blocks"]):
        key = f"down_block_{i}"
        h, new_cache[key] = _resnet_stack(block["resnets"], h, None, cache.get(key), g)
        if "downsampler" in block:
            h = downsample3d(block["downsampler"], h, compress_time=i < _TEMPORAL_LEVELS)
    h, new_cache["mid_block"] = _resnet_stack(params["mid_block"]["resnets"], h, None, cache.get("mid_block"), g)
    h = F.silu(group_norm(h, params["norm_out"]["weight"], params["norm_out"]["bias"], g))
    h, new_cache["conv_out"] = causal_conv3d(params["conv_out"], h, cache.get("conv_out"))
    return h, new_cache


def decoder_forward(params: dict, cfg: VAEConfig, z: torch.Tensor, cache=None):
    """``[B, latent, T, h, w]`` -> (``[B, 3, T', 8h, 8w]``, new_cache); every
    decoder norm is a SpatialNorm3D conditioned on the input chunk z."""
    cache = cache or {}
    new_cache = {}
    g = cfg.norm_num_groups
    h, new_cache["conv_in"] = causal_conv3d(params["conv_in"], z, cache.get("conv_in"))
    h, new_cache["mid_block"] = _resnet_stack(params["mid_block"]["resnets"], h, z, cache.get("mid_block"), g)
    for i, block in enumerate(params["up_blocks"]):
        key = f"up_block_{i}"
        h, new_cache[key] = _resnet_stack(block["resnets"], h, z, cache.get(key), g)
        if "upsampler" in block:
            h = upsample3d(block["upsampler"], h, compress_time=i < _TEMPORAL_LEVELS)
    h = F.silu(spatial_norm3d(params["norm_out"], h, z, g))
    h, new_cache["conv_out"] = causal_conv3d(params["conv_out"], h, cache.get("conv_out"))
    return h, new_cache


def _chunk_bounds(num_frames: int, chunk: int):
    """Reference chunk schedule: the remainder folds into chunk 0."""
    num_batches = max(num_frames // chunk, 1)
    rem = num_frames % chunk
    return [
        (chunk * i + (0 if i == 0 else rem), min(chunk * (i + 1) + rem, num_frames))
        for i in range(num_batches)
    ]


def _streamed(forward, params, cfg, x, chunk: int):
    """Run ``forward`` chunk by chunk over frames (dim 2), threading the conv cache."""
    outs = []
    cache = None
    for start, end in _chunk_bounds(x.shape[2], chunk):
        y, cache = forward(params, cfg, x[:, :, start:end], cache)
        outs.append(y)
    return torch.cat(outs, dim=2) if len(outs) > 1 else outs[0]


def _encode_plain(params, cfg: VAEConfig, x):
    return _streamed(encoder_forward, params["encoder"], cfg, x, cfg.num_sample_frames_batch_size)


def _decode_plain(params, cfg: VAEConfig, z):
    return _streamed(decoder_forward, params["decoder"], cfg, z, cfg.num_latent_frames_batch_size)


def blend_v(a: torch.Tensor, b: torch.Tensor, extent: int) -> torch.Tensor:
    """Blend b's first ``extent`` rows (dim 3) with a's last."""
    extent = min(a.shape[3], b.shape[3], extent)
    if extent == 0:
        return b
    w = (torch.arange(extent, dtype=torch.float32, device=b.device) / extent).reshape(1, 1, 1, extent, 1).to(b.dtype)
    blended = a[:, :, :, -extent:] * (1 - w) + b[:, :, :, :extent] * w
    return torch.cat([blended, b[:, :, :, extent:]], dim=3)


def blend_h(a: torch.Tensor, b: torch.Tensor, extent: int) -> torch.Tensor:
    """Blend b's first ``extent`` columns (dim 4) with a's last."""
    extent = min(a.shape[4], b.shape[4], extent)
    if extent == 0:
        return b
    w = (torch.arange(extent, dtype=torch.float32, device=b.device) / extent).reshape(1, 1, 1, 1, extent).to(b.dtype)
    blended = a[..., -extent:] * (1 - w) + b[..., :extent] * w
    return torch.cat([blended, b[..., extent:]], dim=4)


def _tiled(params, cfg: VAEConfig, x, encode: bool):
    """Tiled encode/decode of a channels-first input with overlap blending."""
    if encode:
        tile_in_h, tile_in_w = cfg.tile_sample_min_height, cfg.tile_sample_min_width
        tile_out_h, tile_out_w = cfg.tile_latent_min_height, cfg.tile_latent_min_width
        run = _encode_plain
    else:
        tile_in_h, tile_in_w = cfg.tile_latent_min_height, cfg.tile_latent_min_width
        tile_out_h, tile_out_w = cfg.tile_sample_min_height, cfg.tile_sample_min_width
        run = _decode_plain
    overlap_h = int(tile_in_h * (1 - cfg.tile_overlap_factor_height))
    overlap_w = int(tile_in_w * (1 - cfg.tile_overlap_factor_width))
    blend_e_h = int(tile_out_h * cfg.tile_overlap_factor_height)
    blend_e_w = int(tile_out_w * cfg.tile_overlap_factor_width)
    limit_h = tile_out_h - blend_e_h
    limit_w = tile_out_w - blend_e_w

    height, width = x.shape[3], x.shape[4]
    rows = [
        [run(params, cfg, x[:, :, :, i:i + tile_in_h, j:j + tile_in_w]) for j in range(0, width, overlap_w)]
        for i in range(0, height, overlap_h)
    ]
    result_rows = []
    for i, row in enumerate(rows):
        result_row = []
        for j, tile in enumerate(row):
            if i > 0:
                tile = blend_v(rows[i - 1][j], tile, blend_e_h)
            if j > 0:
                tile = blend_h(row[j - 1], tile, blend_e_w)
            result_row.append(tile[:, :, :, :limit_h, :limit_w])
        result_rows.append(torch.cat(result_row, dim=4))
    return torch.cat(result_rows, dim=3)


def vae_encode(params: dict, cfg: VAEConfig, x: torch.Tensor, use_tiling: bool = True, use_slicing: bool = True):
    """Pixels ``[B, T, H, W, 3]`` -> posterior moments ``[B, T', h, w, 2*latent]``."""
    if use_slicing and x.shape[0] > 1:
        return torch.cat([vae_encode(params, cfg, x[i:i + 1], use_tiling, False) for i in range(x.shape[0])])
    xc = x.permute(0, 4, 1, 2, 3)
    if use_tiling and (x.shape[2] > cfg.tile_sample_min_height or x.shape[3] > cfg.tile_sample_min_width):
        out = _tiled(params, cfg, xc, encode=True)
    else:
        out = _encode_plain(params, cfg, xc)
    return out.permute(0, 2, 3, 4, 1)


def vae_decode(params: dict, cfg: VAEConfig, z: torch.Tensor, use_tiling: bool = True, use_slicing: bool = True):
    """Latents ``[B, T, h, w, latent]`` -> pixels ``[B, T', H, W, 3]``."""
    if use_slicing and z.shape[0] > 1:
        return torch.cat([vae_decode(params, cfg, z[i:i + 1], use_tiling, False) for i in range(z.shape[0])])
    zc = z.permute(0, 4, 1, 2, 3)
    if use_tiling and (z.shape[2] > cfg.tile_latent_min_height or z.shape[3] > cfg.tile_latent_min_width):
        out = _tiled(params, cfg, zc, encode=False)
    else:
        out = _decode_plain(params, cfg, zc)
    return out.permute(0, 2, 3, 4, 1)


def gaussian_sample(moments: torch.Tensor, noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Posterior sample (or the mean when ``noise`` is None); channels-last moments."""
    mean, logvar = moments.chunk(2, dim=-1)
    if noise is None:
        return mean
    logvar = logvar.clamp(-30.0, 20.0)
    return mean + torch.exp(0.5 * logvar) * noise


def init_vae_params_random(
    cfg: VAEConfig,
    seed: int = 0,
    device: Optional[Union[str, torch.device]] = None,
) -> dict:
    """Random weights for the full VAE structure, made on the device in
    ``cfg.dtype``: uniform(±1/√fan_in) kernels, zero biases, unit norms (the
    JAX package's ``init_vae_params`` scheme).  For runs without a checkpoint."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    dt = cfg.dtype

    def conv(cout, cin, *k):
        fan_in = cin
        for n in k:
            fan_in *= n
        s = fan_in ** -0.5
        w = torch.empty((cout, cin, *k), dtype=dt, device=device).uniform_(-s, s, generator=gen)
        return {"weight": w, "bias": torch.zeros(cout, dtype=dt, device=device)}

    def gn(c):
        return {"weight": torch.ones(c, dtype=dt, device=device), "bias": torch.zeros(c, dtype=dt, device=device)}

    def spatial_norm(c, zc):
        return {"norm": gn(c), "conv_y": conv(c, zc, 1, 1, 1), "conv_b": conv(c, zc, 1, 1, 1)}

    def resnet(cin, cout, zc):
        p = {"conv1": conv(cout, cin, 3, 3, 3), "conv2": conv(cout, cout, 3, 3, 3)}
        p["norm1"] = gn(cin) if zc is None else spatial_norm(cin, zc)
        p["norm2"] = gn(cout) if zc is None else spatial_norm(cout, zc)
        if cin != cout:
            p["conv_shortcut"] = conv(cout, cin, 1, 1, 1)
        return p

    chans = cfg.block_out_channels
    lc = cfg.latent_channels
    enc = {"conv_in": conv(chans[0], cfg.in_channels, 3, 3, 3), "down_blocks": []}
    out_c = chans[0]
    for i, c in enumerate(chans):
        in_c, out_c = out_c, c
        block = {"resnets": [resnet(in_c if j == 0 else out_c, out_c, None) for j in range(cfg.layers_per_block)]}
        if i < len(chans) - 1:
            block["downsampler"] = {"conv": conv(out_c, out_c, 3, 3)}
        enc["down_blocks"].append(block)
    enc["mid_block"] = {"resnets": [resnet(chans[-1], chans[-1], None) for _ in range(2)]}
    enc["norm_out"] = gn(chans[-1])
    enc["conv_out"] = conv(2 * lc, chans[-1], 3, 3, 3)

    rev = list(reversed(chans))
    dec = {"conv_in": conv(rev[0], lc, 3, 3, 3), "up_blocks": []}
    dec["mid_block"] = {"resnets": [resnet(rev[0], rev[0], lc) for _ in range(2)]}
    out_c = rev[0]
    for i, c in enumerate(rev):
        in_c, out_c = out_c, c
        block = {"resnets": [resnet(in_c if j == 0 else out_c, out_c, lc) for j in range(cfg.layers_per_block + 1)]}
        if i < len(rev) - 1:
            block["upsampler"] = {"conv": conv(out_c, out_c, 3, 3)}
        dec["up_blocks"].append(block)
    dec["norm_out"] = spatial_norm(rev[-1], lc)
    dec["conv_out"] = conv(cfg.out_channels, rev[-1], 3, 3, 3)
    return {"encoder": enc, "decoder": dec}
