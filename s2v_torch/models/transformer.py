"""CogVideoX 3-stream DiT (counterpart of ``s2v_tpu/models/transformer.py``).

Parameters are a dict in torch layouts (linear weights ``[out, in]``) with
one dict per block in ``params["blocks"]``; the forward is a Python loop over
the blocks.  Inside a block the sequence is ``[text | ref | video]``.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

from s2v_torch.config import TransformerConfig
from s2v_torch.ops.adaln import ada_layer_norm_out, ada_layer_norm_zero_3stream
from s2v_torch.ops.attention import joint_attention
from s2v_torch.ops.norms import layer_norm
from s2v_torch.ops.patchify import patchify_video, unpatchify_video
from s2v_torch.ops.quant import dense
from s2v_torch.ops.timestep import get_timestep_embedding, timestep_embedding_mlp
from s2v_torch.utils.device import resolve_device


def _feed_forward(p: dict, x: torch.Tensor) -> torch.Tensor:
    """gelu(tanh) MLP."""
    return dense(p["net_2"], F.gelu(dense(p["net_0"], x), approximate="tanh"))


def block_forward(
    p: dict,
    video: torch.Tensor,
    text: torch.Tensor,
    ref: torch.Tensor,
    temb: torch.Tensor,
    rope_cos: Optional[torch.Tensor],
    rope_sin: Optional[torch.Tensor],
    cfg: TransformerConfig,
    attention_backend: str = "plain",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One CogVideoX block; ``ref`` may be zero-width ``[B, 0, D]`` (T2V)."""
    t_len = text.shape[1]
    r_len = ref.shape[1]
    v_n, t_n, r_n, g_v, g_t, g_r = ada_layer_norm_zero_3stream(p["norm1"], video, text, ref, temb, cfg.norm_eps)
    x = torch.cat([t_n, r_n, v_n], dim=1)
    attn = joint_attention(
        p["attn"], x, cfg.num_attention_heads, rope_cos, rope_sin, cfg.qk_norm_eps, backend=attention_backend
    )
    video = video + g_v * attn[:, t_len + r_len:]
    text = text + g_t * attn[:, :t_len]
    ref = ref + g_r * attn[:, t_len:t_len + r_len]

    v_n, t_n, r_n, g_v, g_t, g_r = ada_layer_norm_zero_3stream(p["norm2"], video, text, ref, temb, cfg.norm_eps)
    ff = _feed_forward(p["ff"], torch.cat([t_n, r_n, v_n], dim=1))
    video = video + g_v * ff[:, t_len + r_len:]
    text = text + g_t * ff[:, :t_len]
    ref = ref + g_r * ff[:, t_len:t_len + r_len]
    return video, text, ref


def transformer_forward(
    params: dict,
    cfg: TransformerConfig,
    video_latents: torch.Tensor,  # [B, F, H, W, C]
    ref_latents: Optional[torch.Tensor],  # [B, Fr, Hr, Wr, C]; None = T2V
    text_embeds: torch.Tensor,  # [B, T, text_embed_dim]
    timestep: torch.Tensor,  # [B]
    rope_cos: Optional[torch.Tensor] = None,  # [S_total, head_dim/2]
    rope_sin: Optional[torch.Tensor] = None,
    attention_backend: str = "plain",
) -> torch.Tensor:
    """Predict the denoising target ``[B, F, H, W, out_channels]``."""
    b, f, h, w, _ = video_latents.shape
    p = cfg.patch_size
    dt = cfg.dtype

    t_emb = get_timestep_embedding(timestep, cfg.inner_dim, cfg.flip_sin_to_cos, float(cfg.freq_shift))
    temb = timestep_embedding_mlp(params["time_embedding"], t_emb.to(dt))

    pe = params["patch_embed"]
    text = dense(pe["text_proj"], text_embeds.to(dt))
    video = patchify_video(video_latents.to(dt), pe["proj"]["weight"], pe["proj"]["bias"], p)
    if ref_latents is None:
        ref = video[:, :0]
    else:
        ref = patchify_video(ref_latents.to(dt), pe["proj"]["weight"], pe["proj"]["bias"], p)

    for layer in params["blocks"]:
        video, text, ref = block_forward(layer, video, text, ref, temb, rope_cos, rope_sin, cfg, attention_backend)

    # final norm over [text | video]; the ref stream ends here
    joint = layer_norm(torch.cat([text, video], dim=1), params["norm_final"]["weight"],
                       params["norm_final"]["bias"], cfg.norm_eps)
    video = joint[:, text.shape[1]:]
    video = ada_layer_norm_out(params["norm_out"], video, temb, cfg.norm_eps)
    video = dense(params["proj_out"], video)
    return unpatchify_video(video, f, h, w, p, cfg.out_channels)


def init_transformer_params_random(
    cfg: TransformerConfig,
    seed: int = 0,
    device: Optional[Union[str, torch.device]] = None,
    scale: float = 0.02,
) -> dict:
    """Random weights at any width, made on the device in ``cfg.dtype``:
    normal × ``scale`` kernels, zero biases, unit norm weights (modelled on
    ``init_transformer_params_stacked``).  For runs without a checkpoint."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    dt = cfg.dtype
    d, td, hd = cfg.inner_dim, cfg.time_embed_dim, cfg.attention_head_dim
    pp = cfg.patch_size ** 2

    def lin(out_dim, in_dim):
        w = torch.empty((out_dim, in_dim), dtype=dt, device=device).normal_(0.0, scale, generator=gen)
        return {"weight": w, "bias": torch.zeros(out_dim, dtype=dt, device=device)}

    def norm(dim):
        return {"weight": torch.ones(dim, dtype=dt, device=device), "bias": torch.zeros(dim, dtype=dt, device=device)}

    blocks = [
        {
            "norm1": {"linear": lin(6 * d, td), "norm": norm(d)},
            "attn": {"qkv": lin(3 * d, d), "norm_q": norm(hd), "norm_k": norm(hd), "to_out": lin(d, d)},
            "norm2": {"linear": lin(6 * d, td), "norm": norm(d)},
            "ff": {"net_0": lin(cfg.ff_inner_dim, d), "net_2": lin(d, cfg.ff_inner_dim)},
        }
        for _ in range(cfg.num_layers)
    ]
    return {
        "patch_embed": {"proj": lin(d, pp * cfg.in_channels), "text_proj": lin(d, cfg.text_embed_dim)},
        "time_embedding": {"linear_1": lin(td, d), "linear_2": lin(td, td)},
        "blocks": blocks,
        "norm_final": norm(d),
        "norm_out": {"linear": lin(2 * d, td), "norm": norm(d)},
        "proj_out": lin(pp * cfg.out_channels, d),
    }
