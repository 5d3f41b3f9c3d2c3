"""The system under test, built as a user's process holds it: the port's
``S2VPipeline`` with its DiT, VAE and T5 resident on the device, their
weights handed over as published-layout state dicts through the port's own
converters (``s2v_torch.loaders.hf``).  The entries drive it; nothing here
is timed except as set-up."""

from __future__ import annotations

import dataclasses
import gc

import torch

from benchmark import weights

DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16, "float32": torch.float32}


def _fields(cls, raw: dict, **extra):
    names = {f.name for f in dataclasses.fields(cls)}
    kw = {k: tuple(v) if isinstance(v, list) else v for k, v in raw.items() if k in names}
    kw.update(extra)
    return cls(**kw)


def configs(cfg: dict):
    """The port's (transformer, VAE, T5, scheduler) configs of a configuration file."""
    from s2v_torch.config import SchedulerConfig, T5Config, TransformerConfig, VAEConfig

    dt = DTYPES[cfg["dtype"]]
    return (_fields(TransformerConfig, cfg["transformer"], dtype=dt), _fields(VAEConfig, cfg["vae"], dtype=dt),
            _fields(T5Config, cfg["text_encoder"], dtype=dt), _fields(SchedulerConfig, cfg["scheduler"]))


def build_pipeline(cfg: dict, seed: int, device, attention_backend: str = "auto"):
    """The pipeline on ``device`` with the seed's weights."""
    from s2v_torch.loaders.hf import convert_t5_state_dict, convert_transformer_state_dict, convert_vae_state_dict
    from s2v_torch.pipelines.s2v import S2VPipeline

    tcfg, vcfg, t5cfg, scfg = configs(cfg)
    dt = DTYPES[cfg["dtype"]]
    with torch.no_grad():
        sd, bufs = weights.dit_state_dict(cfg, seed, device, dt)
        dit = convert_transformer_state_dict(sd, tcfg)
        del sd, bufs
        sd, bufs = weights.vae_state_dict(cfg, seed, device, dt)
        vae = convert_vae_state_dict(sd, vcfg)
        del sd, bufs
        t5 = None
        if "text_encoder" in cfg.get("resident", ()):
            sd, bufs = weights.t5_state_dict(cfg, seed, device, dt)
            t5 = convert_t5_state_dict(sd, t5cfg)
            del sd, bufs
    pipe = S2VPipeline(transformer_params=dit, transformer_cfg=tcfg, vae_params=vae, vae_cfg=vcfg,
                       t5_params=t5, t5_cfg=t5cfg if t5 is not None else None, scheduler_cfg=scfg,
                       device=device, attention_backend=attention_backend)
    return pipe


def release(device) -> None:
    """Return what the program held to the device, before the reference runs."""
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def randn(shape, seed: int, stream: str, device, dtype, index: int = 0) -> torch.Tensor:
    """Standard-normal inputs of one named stream of the seed, made on the device."""
    g = weights.generator(device, seed, stream, index)
    return torch.randn(shape, generator=g, device=device, dtype=torch.float32).to(dtype)
