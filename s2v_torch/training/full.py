"""The v-prediction objective (counterpart of ``s2v_tpu/training/full.py``
``vpred_loss``).  Full fine-tuning (``make_full_train_step``) and its FSDP
specs are later work."""

from __future__ import annotations

from typing import Dict, Optional, Union

import torch

from s2v_torch.config import TransformerConfig
from s2v_torch.models.transformer import transformer_forward
from s2v_torch.schedulers.ddim import add_noise, get_velocity


def cast_floating(tree, dtype: torch.dtype):
    """Every floating tensor of a nested dict/list/tuple tree cast to ``dtype``."""
    if isinstance(tree, dict):
        return {k: cast_floating(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(cast_floating(v, dtype) for v in tree)
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return tree.to(dtype)
    return tree


def vpred_loss(
    params: dict,
    cfg: TransformerConfig,
    batch: Dict[str, torch.Tensor],
    alphas_cumprod: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    attention_backend: str = "plain",
    remat: Union[bool, str] = True,
    compute_dtype: Optional[torch.dtype] = None,
    timesteps: Optional[torch.Tensor] = None,
    noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """v-prediction MSE on noised video latents (the CogVideoX objective).

    batch: ``video_latents [B, F, h, w, C]``, ``ref_latents [B, 1, h, w, C]``,
    ``text_embeds [B, T, txt]``, optional ``rope_cos``/``rope_sin``, and for
    a model without RoPE (the 2b family) an optional ``pos_embedding``, the
    sincos table of ``S2VPipeline.prepare_pos_embedding`` (the JAX
    package's loss reads no table, so its 2b training runs without
    positions: ROADMAP C.19).  One
    timestep per batch row from ``[0, len(alphas_cumprod))`` and the noise
    are drawn on the latents' device from ``generator`` (a generator of that
    device), timesteps first; ``timesteps=``/``noise=`` hand them in
    instead (how a test feeds the JAX package's draws).
    ``compute_dtype`` casts the floating params for the forward (fp32
    master params under a bf16 model config); the forward computes in
    ``cfg.dtype``, so the two must agree."""
    if compute_dtype is not None:
        if compute_dtype != cfg.dtype:
            raise ValueError(f"compute_dtype {compute_dtype} must be the model config's dtype {cfg.dtype}")
        params = cast_floating(params, compute_dtype)
    x0 = batch["video_latents"]
    if timesteps is None:
        timesteps = torch.randint(0, alphas_cumprod.shape[0], (x0.shape[0],), generator=generator,
                                  device=x0.device)
    if noise is None:
        noise = torch.randn(x0.shape, generator=generator, device=x0.device, dtype=torch.float32)
    noise = noise.to(x0.device, x0.dtype)
    timesteps = timesteps.to(x0.device)
    noisy = add_noise(x0, noise, alphas_cumprod, timesteps)
    target = get_velocity(x0, noise, alphas_cumprod, timesteps)
    pred = transformer_forward(
        params, cfg, noisy, batch["ref_latents"], batch["text_embeds"], timesteps,
        batch.get("rope_cos"), batch.get("rope_sin"), attention_backend=attention_backend, remat=remat,
        pos_embedding=batch.get("pos_embedding"),
    )
    return torch.mean(torch.square(pred.float() - target.float()))
