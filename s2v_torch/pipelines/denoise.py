"""The CFG denoising loop (counterpart of ``s2v_tpu/pipelines/denoise.py``).

The JAX package traces the loop into one ``fori_loop``; here it is a Python
loop of transformer forwards and DDIM updates.  CFG duplicates the ref
tokens into the uncond half.  ``batched`` runs uncond | cond as one 2B
forward, ``sequential`` as two B forwards (same math).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from s2v_torch.config import SchedulerConfig, TransformerConfig
from s2v_torch.models.transformer import transformer_forward
from s2v_torch.schedulers.ddim import alpha_pair_for_step, compute_alphas_cumprod, ddim_step, get_timesteps

CFG_MODES = ("batched", "sequential")


def guidance_schedule(guidance_scale: float, num_steps: int, use_dynamic_cfg: bool) -> np.ndarray:
    """Per-step guidance scales; the dynamic cosine schedule is indexed by
    the loop step, not the timestep value."""
    if not use_dynamic_cfg:
        return np.full(num_steps, guidance_scale, np.float32)
    i = np.arange(num_steps, dtype=np.float64)
    g = 1.0 + guidance_scale * ((1.0 - np.cos(math.pi * ((num_steps - i) / num_steps) ** 5.0)) / 2.0)
    return g.astype(np.float32)


@dataclass(frozen=True)
class DenoiseSchedule:
    """Host-precomputed per-step tables (DDIM only in the port so far)."""

    timesteps: np.ndarray
    alpha_t: np.ndarray
    alpha_prev: np.ndarray
    guidance: np.ndarray
    prediction_type: str

    @classmethod
    def create(
        cls,
        scheduler_cfg: SchedulerConfig,
        num_inference_steps: int,
        guidance_scale: float,
        use_dynamic_cfg: bool = False,
    ) -> "DenoiseSchedule":
        ac = compute_alphas_cumprod(scheduler_cfg)
        ts = get_timesteps(scheduler_cfg, num_inference_steps)
        a_t, a_prev = alpha_pair_for_step(
            ac, ts, scheduler_cfg.num_train_timesteps, num_inference_steps, scheduler_cfg.set_alpha_to_one
        )
        return cls(
            timesteps=ts,
            alpha_t=a_t,
            alpha_prev=a_prev,
            guidance=guidance_schedule(guidance_scale, num_inference_steps, use_dynamic_cfg),
            prediction_type=scheduler_cfg.prediction_type,
        )


def denoise(
    params: dict,
    cfg: TransformerConfig,
    schedule: DenoiseSchedule,
    latents: torch.Tensor,  # [B, F, h, w, C]
    ref_latents: Optional[torch.Tensor],  # [B, 1, h, w, C]; None = T2V
    prompt_embeds: torch.Tensor,  # [2B (uncond | cond), T, text_dim], or [B, ...] without CFG
    rope_cos: Optional[torch.Tensor],
    rope_sin: Optional[torch.Tensor],
    do_cfg: bool = True,
    attention_backend: str = "plain",
    cfg_mode: str = "batched",
    step_callback=None,
) -> torch.Tensor:
    """Run the denoise loop; returns the final latents ``[B, F, h, w, C]``.
    ``step_callback(i)``, when given, is called after each step."""
    if cfg_mode not in CFG_MODES:
        raise ValueError(f"unknown cfg_mode {cfg_mode!r}; expected one of {CFG_MODES}")
    batched = do_cfg and cfg_mode == "batched"
    ref_in = ref_latents
    if ref_latents is not None and batched:
        ref_in = torch.cat([ref_latents, ref_latents], dim=0)
    if do_cfg and not batched:
        emb_uncond, emb_cond = prompt_embeds.chunk(2, dim=0)

    def fwd(lat_in, ref, emb, t):
        ts = torch.full((lat_in.shape[0],), int(t), dtype=torch.int32, device=lat_in.device)
        return transformer_forward(
            params, cfg, lat_in, ref, emb, ts, rope_cos, rope_sin, attention_backend=attention_backend
        ).float()

    for i, t in enumerate(schedule.timesteps):
        g = float(schedule.guidance[i])
        if batched:
            uncond, cond = fwd(torch.cat([latents, latents], dim=0), ref_in, prompt_embeds, t).chunk(2, dim=0)
            noise_pred = uncond + g * (cond - uncond)
        elif do_cfg:
            uncond = fwd(latents, ref_latents, emb_uncond, t)
            noise_pred = uncond + g * (fwd(latents, ref_latents, emb_cond, t) - uncond)
        else:
            noise_pred = fwd(latents, ref_latents, prompt_embeds, t)
        latents, _ = ddim_step(
            noise_pred, latents, float(schedule.alpha_t[i]), float(schedule.alpha_prev[i]), schedule.prediction_type
        )
        if step_callback is not None:
            step_callback(i)
    return latents
