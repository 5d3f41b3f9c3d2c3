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


def _shard(mesh, n_frames, tpf):
    from s2v_torch.parallel.context import FrameShard

    group = mesh.get_group("seq")
    return FrameShard(n_frames, tpf, dist.get_world_size(group), dist.get_rank(group), group)


def _rows(x, g, shard):
    """This rank's rows [text | ref | its frames] of a whole [B, S, H, d]."""
    return torch.cat([x[:, :g], shard.take(x[:, g:])], dim=1)


def _own(x, g, shard, dim=1):
    """A rank's own rows as it computed them: [text | ref | its real
    frames], the dummy frames dropped; nothing is collected from the other
    ranks, so the parent test holds each rank's work on its own."""
    return _np(x.narrow(dim, 0, g + shard.real_frames * shard.tokens_per_frame))


def rows_of(whole, res, dim=1):
    """The rows of a whole numpy array (the JAX side) that a rank's
    :func:`case_attention` result ``res`` holds."""
    g, tpf, first, real = res["rows"]
    video = np.arange(g + first * tpf, g + (first + real) * tpf)
    return np.take(whole, np.concatenate([np.arange(g), video]), axis=dim)


def global_rows(x, res, dim=1):
    return np.take(x, np.arange(res["rows"][0]), axis=dim)


def video_rows(x, res, dim=1):
    return np.take(x, np.arange(res["rows"][0], x.shape[dim]), axis=dim)


def assert_rows_match(results, case, want, keys, atol, rtol, dim=1):
    """Every rank's own rows of ``keys`` against the same rows of ``want``."""
    for rank, res in enumerate(results):
        got = res[case]
        for key in keys:
            np.testing.assert_allclose(got[key], rows_of(want, got, dim), atol=atol, rtol=rtol,
                                       err_msg=f"rank {rank} {case} {key}")


def assert_grads_match(results, case, want, atol, rtol):
    """dq, dk, dv of :func:`case_attention`: each rank's video rows against
    the same rows of ``want``, and the ranks' shares of the global rows
    summed here against ``want``'s global rows."""
    for name, w in zip(("dq", "dk", "dv"), want):
        summed = sum(global_rows(res[case][name], res[case]) for res in results)
        np.testing.assert_allclose(summed, global_rows(w, results[0][case]), atol=atol, rtol=rtol,
                                   err_msg=f"{case} {name} global rows")
        for rank, res in enumerate(results):
            got = res[case]
            np.testing.assert_allclose(video_rows(got[name], got), video_rows(rows_of(w, got), got), atol=atol,
                                       rtol=rtol, err_msg=f"rank {rank} {case} {name} video rows")


def global_rows_spread(results, case, keys=("o_inference", "o", "lse")):
    """The largest difference between a rank's own global rows of ``keys``
    and rank 0's: each rank computes the replicated text and ref rows itself."""
    first = results[0][case]
    spread = 0.0
    for res in results[1:]:
        for key in keys:
            if key in first:
                dim = 2 if key == "lse" else 1
                spread = max(spread, float(np.abs(global_rows(res[case][key], res[case], dim)
                                                  - global_rows(first[key], first, dim)).max()))
    return spread


def _wrapper(backend):
    from s2v_torch.parallel import ring_attention as ra
    from s2v_torch.parallel import sp_attention as spa

    return {
        "sp_windowed": (lambda q, k, v, sh, g, w, lse=False: spa.banded_allgather_attention(q, k, v, sh, g, w,
                                                                                          return_lse=lse),
                        lambda q, k, v, sh, g, w: spa.banded_allgather_attention_trainable(q, k, v, sh, g, w)),
        "sp_allgather": (lambda q, k, v, sh, g, w, lse=False: spa.allgather_kv_attention(q, k, v, sh, g, lse),
                         lambda q, k, v, sh, g, w: spa.allgather_kv_attention_trainable(q, k, v, sh, g)),
        "sp_int8": (lambda q, k, v, sh, g, w, lse=False: spa.allgather_kv_attention(q, k, v, sh, g, int8=True),
                    lambda q, k, v, sh, g, w: spa.int8_allgather_attention(q, k, v, sh, g)),
        "sp_ulysses": (lambda q, k, v, sh, g, w, lse=False: spa.ulysses_attention(q, k, v, sh, g),
                       lambda q, k, v, sh, g, w: spa.ulysses_attention_trainable(q, k, v, sh, g)),
        "ring": (lambda q, k, v, sh, g, w, lse=False: ra.ring_attention(q, k, v, sh, g, lse),
                 lambda q, k, v, sh, g, w: ra.ring_attention_trainable(q, k, v, sh, g)),
    }[backend]


def case_attention(mesh, q, k, v, ct, band, backend="sp_windowed"):
    """A wrapper alone on this rank's rows of whole inputs: the inference
    call, then the trainable call and the grads of ``sum(o * ct)`` (the
    global rows' term on rank 0 only, so it counts once).  Each result is
    this rank's own rows (:func:`_own`); the grads of the replicated global
    rows are this rank's share, those of its video rows whole.  ``rows``:
    (global rows, tokens per frame, first frame, real frames)."""
    g, tpf, w = band
    shard = _shard(mesh, (q.shape[1] - g) // tpf, tpf)
    infer, train = _wrapper(backend)
    rows = [_rows(_t(x), g, shard) for x in (q, k, v)]
    out = {"rows": (g, tpf, shard.first_frame, shard.real_frames)}
    with torch.no_grad():
        out["o_inference"] = _own(infer(*rows, shard, g, w), g, shard)
        if backend in ("ring", "sp_windowed"):
            _, lse = infer(*rows, shard, g, w, lse=True)
            out["lse"] = _own(lse, g, shard, dim=2)
    leaves = [x.clone().requires_grad_() for x in rows]
    o = train(*leaves, shard, g, w)
    ct_rows = _rows(_t(ct), g, shard)
    weight = torch.ones(o.shape[1], 1, 1)
    weight[:g] = float(shard.rank == 0)
    loss = (o * ct_rows * weight).sum()
    out["o"] = _own(o, g, shard)
    if backend == "sp_int8":
        try:
            torch.autograd.grad(loss, leaves)
        except NotImplementedError as e:
            out["backward_error"] = str(e)
        return out
    grads = torch.autograd.grad(loss, leaves)
    out.update({n: _own(d, g, shard) for n, d in zip(("dq", "dk", "dv"), grads)})
    return out


def _tiny_cfg(window):
    from s2v_torch.config import TransformerConfig

    return TransformerConfig.tiny(attention_window_frames=window)


def case_forward(mesh, params, inputs, window, backend="sp_windowed", cfg_kw=None):
    """``transformer_forward`` with a sequence-parallel backend under the
    mesh context (``cfg_kw``: TransformerConfig.tiny overrides; ``inputs``
    may end with a sincos table)."""
    from s2v_torch.loaders.jax_params import transformer_from_jax
    from s2v_torch.models.transformer import transformer_forward
    from s2v_torch.parallel import default_logical_map, mesh_context

    from s2v_torch.config import TransformerConfig

    cfg = TransformerConfig.tiny(attention_window_frames=window, **(cfg_kw or {}))
    video, ref, text, ts, cs, sn, *pe = inputs
    opt = lambda a: None if a is None else _t(a)  # noqa: E731
    with mesh_context(mesh, default_logical_map(mesh)):
        out = transformer_forward(transformer_from_jax(params, cfg, device="cpu"), cfg, _t(video), opt(ref), _t(text),
                                  torch.from_numpy(ts), opt(cs), opt(sn), attention_backend=backend,
                                  pos_embedding=opt(pe[0]) if pe else None)
    return {"out": _np(out)}


def case_forward_error(mesh, params, inputs, backend):
    """The message ``transformer_forward`` raises with ``backend`` on the mesh."""
    try:
        case_forward(mesh, params, inputs, 1, backend)
    except ValueError as e:
        return {"error": str(e)}
    return {"error": ""}


def case_generate(mesh, tp, vp, inputs, window, backend="sp_windowed", cfg_kw=None):
    """``S2VPipeline.generate`` after ``set_mesh`` and ``set_attention(backend,
    w)``; the warnings the pipeline logged come back too."""
    import logging

    from s2v_torch.config import TransformerConfig, VAEConfig
    from s2v_torch.loaders.jax_params import transformer_from_jax, vae_from_jax
    from s2v_torch.pipelines.s2v import S2VPipeline

    warnings = []

    class _Keep(logging.Handler):
        def emit(self, record):
            if record.levelno >= logging.WARNING:
                warnings.append(record.getMessage())

    handler = _Keep()
    logging.getLogger("s2v_torch.pipeline").addHandler(handler)

    tcfg = TransformerConfig.tiny(**(cfg_kw or {}))
    vcfg = VAEConfig.tiny(latent_channels=4, sample_height=64, sample_width=64)
    pipe = S2VPipeline(transformer_params=transformer_from_jax(tp, tcfg, device="cpu"), transformer_cfg=tcfg,
                       vae_params=vae_from_jax(vp, vcfg, device="cpu"), vae_cfg=vcfg, device="cpu")
    pipe.set_mesh(mesh)
    pipe.set_attention(backend, window)
    latents, ref, embeds, common = inputs
    try:
        got = pipe.generate(latents=_t(latents), ref_latents=_t(ref), prompt_embeds=_t(embeds), **common)
    finally:
        logging.getLogger("s2v_torch.pipeline").removeHandler(handler)
    if common.get("output_type") != "latent":
        got = torch.from_numpy(np.asarray(got))
    return {"latents": _np(got), "backend": pipe.attention_backend, "warnings": warnings}


def case_lora(mesh, base, batch, tree, rank, alpha, timesteps, noise, window, backend="sp_windowed"):
    """The LoRA loss and its grads with a sequence-parallel backend (remat on)."""
    from s2v_torch.loaders.jax_params import lora_from_jax, transformer_from_jax
    from s2v_torch.parallel import default_logical_map, mesh_context
    from s2v_torch.training import lora

    cfg = _tiny_cfg(window)
    mine = lora_from_jax(tree, device="cpu")
    leaves = lora.lora_leaves(mine)
    for x in leaves:
        x.requires_grad_(True)
    batch = dict(batch)
    alphas = torch.from_numpy(batch.pop("alphas_cumprod"))
    with mesh_context(mesh, default_logical_map(mesh)):
        loss = lora.lora_loss_fn(mine, transformer_from_jax(base, cfg, device="cpu"), cfg,
                                 lora.LoRASpec(rank=rank, alpha=alpha), {k: _t(v) for k, v in batch.items()}, alphas,
                                 None, backend, True, timesteps=torch.from_numpy(timesteps), noise=_t(noise))
        grads = torch.autograd.grad(loss, leaves)
    names = [f"{n}.{k}" for n in sorted(mine) for k in ("a", "b")]
    return {"loss": loss.item(), "grads": {n: _np(g) for n, g in zip(names, grads)}}


def case_vae(mesh, vp, latents, pixels):
    """The context-parallel VAE: the uniform decode, the canonical decode
    of each latent clip (or its error), the encode."""
    from s2v_torch.config import VAEConfig
    from s2v_torch.loaders.jax_params import vae_from_jax
    from s2v_torch.parallel import vae_temporal

    cfg = VAEConfig.tiny()
    params = vae_from_jax(vp, cfg, device="cpu")
    out = {"uniform": _np(vae_temporal.sharded_vae_decode(params, cfg, _t(latents["uniform"]), mesh)),
           "encode": _np(vae_temporal.sharded_vae_encode(params, cfg, _t(pixels), mesh))}
    for name, z in latents.items():
        if name.startswith("canonical"):
            try:
                out[name] = _np(vae_temporal.sharded_vae_decode_canonical(params, cfg, _t(z), mesh))
            except ValueError as e:
                out[name] = str(e)
    return out


def case_full_grads(mesh, base, batch, timesteps, noise, backend="sp_allgather"):
    """``vpred_loss`` (full fine-tuning's loss) and its gradients over every
    parameter of the tiny DiT on the mesh."""
    from s2v_torch.config import TransformerConfig
    from s2v_torch.loaders.jax_params import transformer_from_jax
    from s2v_torch.parallel import default_logical_map, mesh_context, sum_grads_over_seq
    from s2v_torch.training.full import floating_leaves, vpred_loss

    cfg = TransformerConfig.tiny()
    params = transformer_from_jax(base, cfg, device="cpu")
    leaves = floating_leaves(params)
    for x in leaves:
        x.requires_grad_(True)
    batch = dict(batch)
    alphas = torch.from_numpy(batch.pop("alphas_cumprod"))
    with mesh_context(mesh, default_logical_map(mesh)):
        loss = vpred_loss(sum_grads_over_seq(params), cfg, {k: _t(v) for k, v in batch.items()}, alphas, None,
                          backend, True, timesteps=torch.from_numpy(timesteps), noise=_t(noise))
        grads = torch.autograd.grad(loss, leaves)
    return {"loss": loss.item(), "grads": [_np(g) for g in grads]}


def case_daemon_outcomes(mesh, requests):
    """A mesh daemon's ranks on ``requests``, each ``{"fail_on": [ranks]}``
    whose handler raises the same error on those ranks: rank 0 dispatches
    each and records its answer or error, the other ranks follow until the
    loop ends."""
    from s2v_torch.serving.daemon import RanksOutOfStep, ServingDaemon

    group = mesh.get_group("seq")
    daemon = ServingDaemon(None, "", control_group=group)
    rank = dist.get_rank(group)

    def handle(req):
        if rank in req["fail_on"]:
            raise ValueError("this request fails here")
        return {"status": "ok", "op": req["op"]}

    daemon.handle = handle
    seen = []
    if rank == 0:
        for req in requests:
            try:
                seen.append(daemon.dispatch(req)["status"])
            except RanksOutOfStep as e:
                seen.append(f"out of step: {e}")
                break
            except ValueError as e:
                seen.append(f"error: {e}")
    else:
        try:
            daemon.follow()
            seen.append("followed to shutdown")
        except RanksOutOfStep:
            seen.append("out of step")
    return {"seen": seen}


def case_spatial(mesh, vp, latents, cfg_kw):
    """The spatial-tile CP decode (``parallel/vae_spatial.py``), whether the
    pipeline takes it, and the single-card tiled decode on this rank."""
    from s2v_torch.config import VAEConfig
    from s2v_torch.loaders.jax_params import vae_from_jax
    from s2v_torch.models.vae import vae_decode
    from s2v_torch.parallel import vae_spatial

    from s2v_torch.pipelines.s2v import S2VPipeline

    cfg = VAEConfig.tiny(**cfg_kw)
    params = vae_from_jax(vp, cfg, device="cpu")
    z = _t(latents)
    out = {"supported": vae_spatial.spatial_cp_supported(cfg, z, mesh, "seq"),
           "cp": _np(vae_spatial.spatial_tiled_decode_cp(params, cfg, z, mesh, "seq")),
           "single": _np(vae_decode(params, cfg, z, use_tiling=True, use_slicing=False))}
    # the pipeline's decode on the ring (latents 10x10 > the native 8x8: tiled) takes the CP route
    pipe = S2VPipeline(transformer_params={}, transformer_cfg=None, vae_params=params, vae_cfg=cfg, device="cpu")
    pipe.set_mesh(mesh)
    calls, decode_cp = [], vae_spatial.spatial_tiled_decode_cp
    vae_spatial.spatial_tiled_decode_cp = lambda *a, **k: calls.append(1) or decode_cp(*a, **k)
    try:
        out["pipeline"] = np.asarray(pipe.decode_latents(z * cfg.scaling_factor))
    finally:
        vae_spatial.spatial_tiled_decode_cp = decode_cp
    out["pipeline_cp_calls"] = len(calls)
    return out


CASES = {"spatial": case_spatial, "daemon_outcomes": case_daemon_outcomes, "attention": case_attention, "forward": case_forward, "forward_error": case_forward_error,
         "generate": case_generate, "lora": case_lora, "vae": case_vae, "full_grads": case_full_grads}


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
