"""Shared tiny-config fixtures for tests, examples and the multi-rank dry run
(counterpart of ``s2v_tpu/testing.py``: ``tiny_pipeline`` :15,
``tiny_generate_kwargs`` :37).

One home for the random-weight tiny pipeline and its ``generate`` arguments,
so the tiny-config generate contract lives in one place.  Like every entry
point of the port, the pipeline is built on the card unless the caller asks
for the CPU (``device="cpu"``).
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def tiny_pipeline(attention_backend: str = "plain", device: Optional[Union[str, torch.device]] = None,
                  **cfg_overrides):
    """An ``S2VPipeline`` over random tiny-config weights (no T5, no
    tokenizer).  ``cfg_overrides`` land on ``TransformerConfig.tiny``, e.g.
    ``num_attention_heads=8`` for a mesh whose seq ring needs more heads
    than the 4-head default.  The default backend is ``plain``, the port's
    counterpart of JAX's ``xla``."""
    from s2v_torch.config import TransformerConfig, VAEConfig
    from s2v_torch.models.transformer import init_transformer_params_random
    from s2v_torch.models.vae import init_vae_params_random
    from s2v_torch.pipelines.s2v import S2VPipeline

    cfg = TransformerConfig.tiny(**cfg_overrides)
    vcfg = VAEConfig.tiny(latent_channels=cfg.in_channels)
    return S2VPipeline(
        transformer_params=init_transformer_params_random(cfg, seed=0, device=device),
        transformer_cfg=cfg,
        vae_params=init_vae_params_random(vcfg, seed=1, device=device),
        vae_cfg=vcfg,
        attention_backend=attention_backend,
        device=device,
    )


def tiny_generate_kwargs(pipe, num_frames: Optional[int] = None, seed: int = 7, **overrides) -> dict:
    """Minimal valid ``generate`` arguments for a tiny pipeline: seeded CFG
    prompt embeddings and ref latents (CPU generators, so every rank draws
    the same) at the smallest divisible geometry."""
    cfg = pipe.transformer_cfg
    sc = pipe.vae_cfg.spatial_compression_ratio
    h = w = 2 * sc * cfg.patch_size
    if num_frames is None:
        num_frames = pipe.vae_cfg.temporal_compression_ratio + 1
    gen = torch.Generator().manual_seed(5)
    embeds = torch.randn(2, cfg.max_text_seq_length, cfg.text_embed_dim, generator=gen)
    ref = torch.randn(1, 1, h // sc, w // sc, cfg.in_channels, generator=gen)
    kw = dict(prompt_embeds=embeds.to(pipe.device), ref_latents=ref.to(pipe.device), height=h, width=w,
              num_frames=num_frames, num_inference_steps=2, guidance_scale=6.0, seed=seed, output_type="np")
    kw.update(overrides)
    return kw
