"""Windowed (sliding temporal window) attention: the opt-in approximate path
(counterpart of ``s2v_tpu/ops/windowed_attention.py``; the exact path is full
joint attention).

Video queries attend only ``[text | ref | frames clamp(f - w .. f + w)]``;
text and ref queries keep full attention.  The window is clamped at the clip
edges, so every frame sees ``min(2w + 1, F)`` frames.  At the 5b geometry
(13 frames of 1,350 tokens, 226 text) a window of 2 computes 48% of full
attention's (query, key) pairs, a window of 1 35%.

:func:`windowed_attention` is the gather path (per-frame key windows copied
out, then one attention call per segment); the banded kernel B4
(``s2v_torch.kernels.banded_attention``) walks the window in place and is the
``windowed`` backend's path.
"""

from __future__ import annotations

import math

import torch

from s2v_torch.kernels.banded_attention import band_geometry, band_mask


def windowed_attention(
    q: torch.Tensor,  # [B, S, H, d], [text | ref | video] order
    k: torch.Tensor,
    v: torch.Tensor,
    global_len: int,  # text + ref tokens: the full-attention segment
    tokens_per_frame: int,
    window_frames: int,  # w: video queries see 2w + 1 frames
    attention_fn=None,  # (q, k, v) -> o; defaults to the port's B1 (flash_attention_trainable)
) -> torch.Tensor:
    if attention_fn is None:
        from s2v_torch.ops.attention import flash_attention_trainable as attention_fn
    b, s, h, d = q.shape
    geo = band_geometry(s, global_len, tokens_per_frame, window_frames)
    n_frames, tpf, span = geo.n_frames, tokens_per_frame, geo.span

    o_glob = attention_fn(q[:, :global_len], k, v)

    # video queries: frames folded into the batch, each with its key window
    qf = q[:, global_len:].reshape(b * n_frames, tpf, h, d)

    def windows(x):
        vid = x[:, global_len:].reshape(b, n_frames, tpf, h, d)
        win = torch.stack([vid[:, geo.window_start(f):geo.window_start(f) + span] for f in range(n_frames)], dim=1)
        glob = x[:, None, :global_len].expand(b, n_frames, global_len, h, d)
        return torch.cat([glob, win.reshape(b, n_frames, span * tpf, h, d)], dim=2).reshape(
            b * n_frames, global_len + span * tpf, h, d)

    o_vid = attention_fn(qf, windows(k), windows(v)).reshape(b, n_frames * tpf, h, d)
    return torch.cat([o_glob, o_vid], dim=1)


def windowed_attention_reference(q, k, v, global_len, tokens_per_frame, window_frames):
    """O(S²) masked-softmax reference for tests (fp32 logits and softmax,
    weights cast to v's dtype)."""
    b, s, h, d = q.shape
    geo = band_geometry(s, global_len, tokens_per_frame, window_frames)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(d)
    mask = band_mask(geo, torch.arange(s, device=q.device), s)
    weights = logits.masked_fill(~mask, float("-inf")).softmax(-1)
    return torch.einsum("bhqk,bkhd->bqhd", weights.to(v.dtype), v)
