"""Rank processes of the ``sp_windowed`` tests.

Each rank imports only torch, numpy and s2v_torch (never JAX): the parent test
computes the JAX side and passes numpy arrays in.  :func:`run_ranks` spawns a
gloo process group of ``world_size`` ranks over a ``FileStore``, runs every
case on every rank under a one-dim ``seq`` mesh, and returns each rank's
results as numpy.  It fails, and never hangs, past its time limit: the group
times out its collectives after 60 s, and the join gives up at ``timeout_s``.
"""

import os
import pickle
import time
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

COLLECTIVE_TIMEOUT_S = 60


def _np(x):
    return x.detach().float().numpy()


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def case_attention(mesh, q, k, v, ct, band):
    """The wrapper alone: the inference call, then the trainable call and the
    grads of ``sum(o * ct)``."""
    from s2v_torch.parallel.sp_attention import banded_allgather_attention, banded_allgather_attention_trainable

    with torch.no_grad():
        o_inf = banded_allgather_attention(_t(q), _t(k), _t(v), mesh, "seq", *band)
    leaves = [_t(x).requires_grad_() for x in (q, k, v)]
    o = banded_allgather_attention_trainable(*leaves, mesh, "seq", *band)
    grads = torch.autograd.grad(o, leaves, _t(ct))
    return {"o_inference": _np(o_inf), "o": _np(o), **{n: _np(g) for n, g in zip(("dq", "dk", "dv"), grads)}}


def _tiny_cfg(window):
    from s2v_torch.config import TransformerConfig

    return TransformerConfig.tiny(attention_window_frames=window)


def case_forward(mesh, params, inputs, window):
    """``transformer_forward`` with ``sp_windowed`` under the mesh context."""
    from s2v_torch.loaders.jax_params import transformer_from_jax
    from s2v_torch.models.transformer import transformer_forward
    from s2v_torch.parallel import default_logical_map, mesh_context

    cfg = _tiny_cfg(window)
    video, ref, text, ts, cs, sn = inputs
    with mesh_context(mesh, default_logical_map(mesh)):
        out = transformer_forward(transformer_from_jax(params, cfg, device="cpu"), cfg, _t(video),
                                  None if ref is None else _t(ref), _t(text), torch.from_numpy(ts), _t(cs), _t(sn),
                                  attention_backend="sp_windowed")
    return {"out": _np(out)}


def case_generate(mesh, tp, vp, inputs, window):
    """``S2VPipeline.generate`` after ``set_mesh`` and ``set_attention("sp_windowed", w)``."""
    from s2v_torch.config import TransformerConfig, VAEConfig
    from s2v_torch.loaders.jax_params import transformer_from_jax, vae_from_jax
    from s2v_torch.pipelines.s2v import S2VPipeline

    tcfg, vcfg = TransformerConfig.tiny(), VAEConfig.tiny(latent_channels=4, sample_height=64, sample_width=64)
    pipe = S2VPipeline(transformer_params=transformer_from_jax(tp, tcfg, device="cpu"), transformer_cfg=tcfg,
                       vae_params=vae_from_jax(vp, vcfg, device="cpu"), vae_cfg=vcfg, device="cpu")
    pipe.set_mesh(mesh)
    pipe.set_attention("sp_windowed", window)
    latents, ref, embeds, common = inputs
    got = pipe.generate(latents=_t(latents), ref_latents=_t(ref), prompt_embeds=_t(embeds), **common)
    return {"latents": _np(got), "backend": pipe.attention_backend}


def case_lora(mesh, base, batch, tree, rank, alpha, timesteps, noise, window):
    """The LoRA loss and its grads with ``sp_windowed`` (remat on)."""
    from s2v_torch.loaders.jax_params import lora_from_jax, transformer_from_jax
    from s2v_torch.parallel import default_logical_map, mesh_context
    from s2v_torch.training import lora

    cfg = _tiny_cfg(window)
    mine = lora_from_jax(tree, device="cpu")
    leaves = lora.lora_leaves(mine)
    for x in leaves:
        x.requires_grad_(True)
    alphas = torch.from_numpy(batch.pop("alphas_cumprod"))
    with mesh_context(mesh, default_logical_map(mesh)):
        loss = lora.lora_loss_fn(mine, transformer_from_jax(base, cfg, device="cpu"), cfg,
                                 lora.LoRASpec(rank=rank, alpha=alpha), {k: _t(v) for k, v in batch.items()}, alphas,
                                 None, "sp_windowed", True, timesteps=torch.from_numpy(timesteps), noise=_t(noise))
        grads = torch.autograd.grad(loss, leaves)
    names = [f"{n}.{k}" for n in sorted(mine) for k in ("a", "b")]
    return {"loss": loss.item(), "grads": {n: _np(g) for n, g in zip(names, grads)}}


CASES = {"attention": case_attention, "forward": case_forward, "generate": case_generate, "lora": case_lora}


def _rank_main(rank, world_size, cases, out_dir):
    from torch.distributed.device_mesh import init_device_mesh

    torch.set_num_threads(2)
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(out_dir, "store"), world_size), rank=rank,
                            world_size=world_size, timeout=timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    try:
        mesh = init_device_mesh("cpu", (world_size,), mesh_dim_names=("seq",))
        results = {name: CASES[kind](mesh, **kwargs) for name, (kind, kwargs) in cases.items()}
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)


def run_ranks(world_size, cases, out_dir, timeout_s=150):
    """Spawn ``world_size`` ranks that run ``cases`` (``{name: (kind,
    kwargs)}``, kinds from :data:`CASES`); returns a list of each rank's
    ``{name: result}``.  Raises when a rank fails or the ranks outlive
    ``timeout_s``."""
    import torch.multiprocessing as mp

    os.makedirs(out_dir, exist_ok=True)
    ctx = mp.start_processes(_rank_main, args=(world_size, cases, str(out_dir)), nprocs=world_size, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + timeout_s
    while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
        if time.monotonic() >= deadline:
            for proc in ctx.processes:
                proc.kill()
            raise TimeoutError(f"{world_size} sp ranks did not finish within {timeout_s} s")
    out = []
    for rank in range(world_size):
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out
