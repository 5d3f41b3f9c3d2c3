"""The plain reference's small pieces: the CogVideoX DDIM schedule and its
v-prediction step, the timestep sinusoid, the 3D RoPE and sincos tables,
written from the published CogVideoX description in numpy and fp32 torch.
Imports nothing of the program."""

from __future__ import annotations

import math

import numpy as np
import torch


def alphas_cumprod(s: dict) -> np.ndarray:
    """alpha-bar over the training timesteps: scaled-linear betas, the SNR
    shift, the zero-terminal-SNR rescale (float64, returned as float32)."""
    n = s["num_train_timesteps"]
    betas = np.linspace(s["beta_start"] ** 0.5, s["beta_end"] ** 0.5, n, dtype=np.float64) ** 2
    ac = np.cumprod(1.0 - betas)
    shift = s.get("snr_shift_scale", 1.0)
    ac = ac / (shift + (1.0 - shift) * ac)
    if s.get("rescale_betas_zero_snr", False):
        a = np.sqrt(ac)
        a0, at = a[0], a[-1]
        a = (a - at) * a0 / (a0 - at)
        ac = a ** 2
    return ac.astype(np.float32)


def timesteps(s: dict, steps: int) -> np.ndarray:
    """The trailing spacing: descending ``round(arange(n, 0, -n/steps)) - 1``."""
    n = s["num_train_timesteps"]
    return (np.round(np.arange(n, 0, -n / steps)).astype(np.int64) - 1)


def ddim_alphas(s: dict, steps: int, i: int):
    """(alpha-bar at step i's timestep, at the previous timestep)."""
    ac, ts = alphas_cumprod(s), timesteps(s, steps)
    prev = ts[i] - s["num_train_timesteps"] // steps
    a_prev = float(ac[prev]) if prev >= 0 else (1.0 if s.get("set_alpha_to_one", True) else float(ac[0]))
    return float(ac[ts[i]]), a_prev


def ddim_v_step(v: torch.Tensor, x: torch.Tensor, a_t: float, a_prev: float) -> torch.Tensor:
    """DDIM (eta 0) from a v-prediction, fp32."""
    x0 = a_t ** 0.5 * x - (1.0 - a_t) ** 0.5 * v
    c_x = ((1.0 - a_prev) / (1.0 - a_t)) ** 0.5
    return c_x * x + (a_prev ** 0.5 - a_t ** 0.5 * c_x) * x0


def timestep_sinusoid(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``[cos | sin]`` of ``t · 10000^(-k/half)`` (flip_sin_to_cos, no shift)."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    arg = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(arg), torch.sin(arg)], dim=-1)


def _rope_1d(dim: int, pos: np.ndarray):
    inv = 1.0 / (10000.0 ** (np.arange(0, dim, 2, dtype=np.float64) / dim))
    ang = np.outer(pos.astype(np.float64), inv)
    return np.cos(ang), np.sin(ang)


def crop_region(grid_h: int, grid_w: int, base_h: int, base_w: int):
    """The grid resized to fit the base grid and centred: ((top, left), (bottom, right))."""
    if grid_h / grid_w > base_h / base_w:
        rh, rw = base_h, int(round(base_h / grid_h * grid_w))
    else:
        rw, rh = base_w, int(round(base_w / grid_w * grid_h))
    top, left = int(round((base_h - rh) / 2.0)), int(round((base_w - rw) / 2.0))
    return (top, left), (top + rh, left + rw)


def rope_tables(head_dim: int, frames: int, grid_h: int, grid_w: int, base_h: int = 30, base_w: int = 45):
    """cos, sin ``[frames·h·w, head_dim/2]`` of the CogVideoX 3D RoPE: a
    quarter of the pairs over time, three eighths each over height and
    width, the token grid placed on the 480x720 base grid (at 480x720 the
    positions are the integers)."""
    dt, dh, dw = head_dim // 4, head_dim // 8 * 3, head_dim // 8 * 3
    (top, left), (bottom, right) = crop_region(grid_h, grid_w, base_h, base_w)
    ct, st = _rope_1d(dt, np.arange(frames))
    ch, sh = _rope_1d(dh, top + (bottom - top) * np.arange(grid_h, dtype=np.float32) / grid_h)
    cw, sw = _rope_1d(dw, left + (right - left) * np.arange(grid_w, dtype=np.float32) / grid_w)

    def grid(a, b, c):
        return np.concatenate([np.broadcast_to(a[:, None, None], (frames, grid_h, grid_w, a.shape[-1])),
                               np.broadcast_to(b[None, :, None], (frames, grid_h, grid_w, b.shape[-1])),
                               np.broadcast_to(c[None, None, :], (frames, grid_h, grid_w, c.shape[-1]))],
                              axis=-1).reshape(frames * grid_h * grid_w, -1)

    return (torch.from_numpy(grid(ct, ch, cw).astype(np.float32)),
            torch.from_numpy(grid(st, sh, sw).astype(np.float32)))


def _sincos_1d(dim: int, pos: np.ndarray) -> np.ndarray:
    omega = 1.0 / 10000 ** (np.arange(dim // 2, dtype=np.float64) / (dim / 2.0))
    out = np.outer(pos.reshape(-1).astype(np.float64), omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


def sincos_table(dim: int, frames: int, grid_h: int, grid_w: int, spatial_scale: float,
                 temporal_scale: float) -> torch.Tensor:
    """The CogVideoX-2b 3D sincos table ``[frames·h·w, dim]``: a quarter of
    the channels over time, then the spatial half over the w-major grid's
    first coordinate and half over its second."""
    ds = 3 * dim // 4
    gw, gh = np.meshgrid(np.arange(grid_w, dtype=np.float32) / spatial_scale,
                         np.arange(grid_h, dtype=np.float32) / spatial_scale)
    spatial = np.concatenate([_sincos_1d(ds // 2, gw), _sincos_1d(ds // 2, gh)], axis=1)
    temporal = _sincos_1d(dim // 4, np.arange(frames, dtype=np.float32) / temporal_scale)
    table = np.concatenate([np.repeat(temporal[:, None], grid_h * grid_w, axis=1),
                            np.repeat(spatial[None], frames, axis=0)], axis=-1)
    return torch.from_numpy(table.reshape(frames * grid_h * grid_w, dim).astype(np.float32))
