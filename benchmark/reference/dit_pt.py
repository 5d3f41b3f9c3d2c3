"""The plain reference of CogVideoX1.5-5B's DiT and of the generate rules
around it: fp32 PyTorch, written from diffusers' ``patch_size_t`` path
(``CogVideoXPatchEmbed``, ``CogVideoXTransformer3DModel.forward``,
``get_3d_rotary_pos_embed(..., grid_type="slice")``) and
``CogVideoXPipeline``, on the blocks of ``benchmark/reference/dit.py``.

- Patch embed: ``[B, F, H, W, C]`` as ``[B, F/pₜ, pₜ, H/p, p, W/p, p, C]``,
  tokens in (t, h, w) order, features in (c, pₜ, ph, pw) order, through
  ``patch_embed.proj`` (a Linear ``[D, C·pₜ·p²]``, its bias only where the
  state dict has one: CogVideoX1.5's ``patch_bias`` is false).
- Output: ``proj_out`` to ``C·pₜ·p²`` features in (c, pₜ, ph, pw) order,
  unpatchified back to ``[B, F, H, W, C]``.
- RoPE: integer positions t in 0..F/pₜ, h in 0..H/p − 1, w in 0..W/p − 1
  (no resize onto a base grid; the table's largest grid is
  ``sample_height/p`` x ``sample_width/p``, and a larger grid is refused),
  the head's 64 channels split 16 / 24 / 24 over (t, h, w), θ = 10⁴,
  worked in float64 and stored in float32.
- Padding (:func:`latent_frames`): latents are drawn at the latent frame
  count padded up to a multiple of pₜ (81 frames: 21 latent frames, 22
  drawn, one padding frame); the leading padding frames are dropped only
  before the decode (:func:`drop_padding`).

Departure, as no subject-to-video checkpoint of CogVideoX1.5 exists: the
subject's one latent frame is repeated pₜ times along time, one temporal
patch, at RoPE temporal index 0, the video's patches at 1..F/pₜ (the 5b
rule "the subject is frame 0 of F + 1", counted in temporal patches).
Attention, ``lowp`` (the fp8 control) and the weights' casts are those of
``dit.DiT``.  Imports nothing of the program.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import dit
from benchmark.reference.schedule import timestep_sinusoid

THETA = 10000.0


def latent_frames(tcfg: dict, num_frames: int) -> Tuple[int, int]:
    """(latent frames drawn, padding frames among them) of a clip of
    ``num_frames`` frames."""
    frames = (num_frames - 1) // tcfg["temporal_compression_ratio"] + 1
    pad = -frames % tcfg["patch_size_t"]
    return frames + pad, pad


def drop_padding(latents: torch.Tensor, pad: int) -> torch.Tensor:
    """The latents the decode takes: the leading ``pad`` frames dropped."""
    return latents[:, pad:]


def _axis(dim: int, n: int) -> Tuple[np.ndarray, np.ndarray]:
    """cos, sin ``[n, dim/2]`` of positions 0..n-1, pair i at θ^(-2i/dim)."""
    inv = 1.0 / THETA ** (np.arange(0, dim, 2, dtype=np.float64) / dim)
    ang = np.arange(n, dtype=np.float64)[:, None] * inv[None]
    return np.cos(ang), np.sin(ang)


def rope_tables(head_dim: int, patches: int, grid_h: int, grid_w: int, max_grid: Tuple[int, int]):
    """cos, sin ``[(patches + 1)·h·w, head_dim/2]`` over ``[ref | video]``:
    the ref's temporal patch at t = 0, the video's at 1..patches."""
    if grid_h > max_grid[0] or grid_w > max_grid[1]:
        raise ValueError(f"a {grid_h} x {grid_w} grid exceeds the RoPE table's {max_grid}")
    dt, dh = head_dim // 4, head_dim // 8 * 3
    t, h, w = patches + 1, grid_h, grid_w
    parts = [_axis(dt, t), _axis(dh, h), _axis(head_dim - dt - dh, w)]
    out = []
    for k in (0, 1):  # cos, then sin
        a, b, c = (p[k] for p in parts)
        grid = np.concatenate([np.broadcast_to(a[:, None, None], (t, h, w, a.shape[-1])),
                               np.broadcast_to(b[None, :, None], (t, h, w, b.shape[-1])),
                               np.broadcast_to(c[None, None, :], (t, h, w, c.shape[-1]))], axis=-1)
        out.append(torch.from_numpy(grid.reshape(t * h * w, -1).astype(np.float32)))
    return tuple(out)


def positions(tcfg: dict, height: int, width: int, num_frames: int):
    """``("rope", cos, sin)`` of a clip at the padded latent frame count."""
    p, pt = tcfg["patch_size"], tcfg["patch_size_t"]
    frames, _ = latent_frames(tcfg, num_frames)
    cos, sin = rope_tables(tcfg["attention_head_dim"], frames // pt, height // 8 // p, width // 8 // p,
                           (tcfg["sample_height"] // p, tcfg["sample_width"] // p))
    return ("rope", cos, sin)


def tokens(tcfg: dict, height: int, width: int, num_frames: int) -> dict:
    """Token counts of a clip: the text, the ref's one temporal patch, the video's patches."""
    p, pt = tcfg["patch_size"], tcfg["patch_size_t"]
    per = (height // 8 // p) * (width // 8 // p)
    frames, _ = latent_frames(tcfg, num_frames)
    return {"text": tcfg["max_text_seq_length"], "ref": per, "video": frames // pt * per}


class DiT(dit.DiT):
    """``dit.DiT`` with 2x2x2 patches over (time, height, width)."""

    def patch_embed(self, x):
        bsz, f, h, w, c = x.shape
        p, pt = self.c["patch_size"], self.c["patch_size_t"]
        x = x.reshape(bsz, f // pt, pt, h // p, p, w // p, p, c).permute(0, 1, 3, 5, 7, 2, 4, 6)
        y = self.mm(x.reshape(bsz, -1, c * pt * p * p), self.w("patch_embed.proj.weight"))
        if "patch_embed.proj.bias" in self.sd:
            y = y + self.w("patch_embed.proj.bias")
        return y

    def forward(self, video, ref, text, t, positions):
        """v-prediction ``[B, F, H, W, C]`` (F a multiple of pₜ) of noised
        latents ``video``, the subject's latents ``ref`` ``[B, 1, H, W, C]``
        (repeated into one temporal patch), prompt embeddings ``text`` and
        integer timesteps ``t``; ``positions`` from :func:`positions`."""
        c = self.c
        bsz, f, h, w, _ = video.shape
        p, pt = c["patch_size"], c["patch_size_t"]
        temb = self.linear(F.silu(self.linear(timestep_sinusoid(t, self.dim), "time_embedding.linear_1")),
                           "time_embedding.linear_2")
        txt = self.linear(text.float(), "patch_embed.text_proj")
        vid = self.patch_embed(video.float())
        rf = self.patch_embed(ref.float().repeat(1, pt, 1, 1, 1) if ref.shape[1] == 1 else ref.float())
        rope = (positions[1].to(vid.device), positions[2].to(vid.device), txt.shape[1])
        for i in range(c["num_layers"]):
            vid, txt, rf = self.block(i, vid, txt, rf, temb, rope)
        vid = dit.layer_norm(vid, self.w("norm_final.weight"), self.w("norm_final.bias"), c["norm_eps"])
        shift, scale = self._modulate("norm_out.linear", temb, None, None, 2)
        vid = dit.layer_norm(vid, self.w("norm_out.norm.weight"), self.w("norm_out.norm.bias"), c["norm_eps"])
        vid = vid * (1 + scale[:, None]) + shift[:, None]
        out = self.linear(vid, "proj_out")  # features (c, pₜ, ph, pw)
        co = c["out_channels"]
        out = out.reshape(bsz, f // pt, h // p, w // p, co, pt, p, p).permute(0, 1, 5, 2, 6, 3, 7, 4)
        return out.reshape(bsz, f, h, w, co)
