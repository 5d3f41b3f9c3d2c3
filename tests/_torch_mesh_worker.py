"""Rank processes of the ``data`` and ``model`` mesh tests.

Each rank imports only torch, numpy and s2v_torch (never JAX): the parent
test computes the JAX side and passes numpy arrays in.  :func:`run_mesh_ranks`
spawns a gloo group of ``world_size`` ranks over a ``FileStore`` and runs
every case on every rank, each case on its own ``DeviceMesh`` of the group
(a spec such as ``"dp2,tp2"``, whose sizes multiply to the world size), and
returns each rank's results as numpy.  It fails, and never hangs, past its
time limit: the group times out its collectives after 60 s, and the join
gives up at ``timeout_s``.
"""

import os
import pickle
import time
from datetime import timedelta

import torch
import torch.distributed as dist

from _torch_sp_worker import COLLECTIVE_TIMEOUT_S, _np, _t


def _ctx(mesh):
    from s2v_torch.parallel import default_logical_map, mesh_context

    return mesh_context(mesh, default_logical_map(mesh))


def _coords(mesh):
    from s2v_torch.parallel.sharding import coords

    return coords(mesh)


def _tiny(params, cfg, mesh):
    """The port's tiny DiT from JAX params, sliced over the mesh's model dim."""
    from s2v_torch.loaders.jax_params import transformer_from_jax
    from s2v_torch.parallel.sharding import shard_params, transformer_param_specs_like

    tree = transformer_from_jax(params, cfg, device="cpu")
    if "model" in (mesh.mesh_dim_names or ()):
        tree = shard_params(tree, mesh, transformer_param_specs_like(tree))
    return tree


def case_forward(mesh, params, inputs, backend="plain"):
    """``transformer_forward`` under the mesh, and what the rank held before
    each gather: its rows of the batch (``gather_rows_over``'s input) and
    its frames (``gather_video``'s), unpatchified to frames."""
    from s2v_torch.config import TransformerConfig
    from s2v_torch.models import transformer as tm
    from s2v_torch.ops.patchify import unpatchify_video

    cfg = TransformerConfig.tiny()
    video, ref, text, ts, cs, sn = inputs
    b, f, h, w, c = video.shape
    held = {}
    rows, frames = tm.gather_rows_over, tm.gather_video

    def keep_rows(x, dp):
        held["rows"] = _np(unpatchify_video(x, f, h, w, cfg.patch_size, cfg.out_channels))
        return rows(x, dp)

    def keep_frames(x, shard):
        held["frames"] = _np(unpatchify_video(x, shard.local_frames, h, w, cfg.patch_size, cfg.out_channels))
        held["first_frame"], held["real_frames"] = shard.first_frame, shard.real_frames
        return frames(x, shard)

    tm.gather_rows_over, tm.gather_video = keep_rows, keep_frames
    try:
        with _ctx(mesh):
            out = tm.transformer_forward(_tiny(params, cfg, mesh), cfg, _t(video), _t(ref), _t(text),
                                         torch.from_numpy(ts), _t(cs), _t(sn), attention_backend=backend)
    finally:
        tm.gather_rows_over, tm.gather_video = rows, frames
    return {"out": _np(out), "coords": _coords(mesh), **held}


def case_heads(mesh, params, x):
    """Block 0's attention on this rank's heads (qkv sliced per head, the qk
    norms, the plain attention), before ``to_out``'s all-reduce."""
    from s2v_torch.config import TransformerConfig
    from s2v_torch.kernels.flash_attention import flash_attention_reference
    from s2v_torch.ops.attention import local_heads, qkv_projections
    from s2v_torch.ops.norms import layer_norm
    from s2v_torch.parallel.context import tensor_parallel

    cfg = TransformerConfig.tiny()
    attn = _tiny(params, cfg, mesh)["blocks"][0]["attn"]
    with _ctx(mesh):
        heads = local_heads(cfg.num_attention_heads, tensor_parallel())
    q, k, v = qkv_projections(attn, _t(x), heads)
    q = layer_norm(q, attn["norm_q"]["weight"], attn["norm_q"]["bias"], cfg.qk_norm_eps)
    k = layer_norm(k, attn["norm_k"]["weight"], attn["norm_k"]["bias"], cfg.qk_norm_eps)
    return {"heads": _np(flash_attention_reference(q, k, v)), "coords": _coords(mesh)}


def case_t5(mesh, params, ids):
    """T5's encode with its params sliced over the model dim."""
    from s2v_torch.config import T5Config
    from s2v_torch.loaders.jax_params import t5_from_jax
    from s2v_torch.models.t5 import t5_encode
    from s2v_torch.parallel.context import tensor_parallel
    from s2v_torch.parallel.sharding import shard_params, t5_param_specs

    cfg = T5Config.tiny(d_model=32)
    tree = t5_from_jax(params, cfg, device="cpu")
    tree = shard_params(tree, mesh, t5_param_specs(tree))
    with _ctx(mesh):
        out = t5_encode(tree, cfg, torch.from_numpy(ids), tp=tensor_parallel())
    return {"out": _np(out), "local_q_rows": tree["blocks"][0]["attn"]["q"]["weight"].shape[0]}


def _optimizer(opt_kw):
    from s2v_torch.training.optim import OptimizerSpec

    return OptimizerSpec(**opt_kw)


def case_lora(mesh, base, tree, batch, draws, rank, alpha, opt_kw, fsdp_base=False, min_size=2 ** 10):
    """The LoRA step, one per draw: on the base sliced over ``model``, or
    (``fsdp_base``) sharded over ``data`` with leaves of ``min_size``
    elements and more sharded; int8 bases come in quantized."""
    from s2v_torch.config import TransformerConfig
    from s2v_torch.loaders.jax_params import lora_from_jax, transformer_from_jax
    from s2v_torch.parallel.sharding import fsdp_param_specs, mesh_sizes, shard_params
    from s2v_torch.training import lora

    cfg = TransformerConfig.tiny()
    base_specs = None
    if fsdp_base:
        base_t = transformer_from_jax(base, cfg, device="cpu")
        base_specs = fsdp_param_specs(base_t, mesh_sizes(mesh)["data"], min_size)
        base_t = shard_params(base_t, mesh, base_specs)
    else:
        base_t = _tiny(base, cfg, mesh)
    mine = lora_from_jax(tree, device="cpu")
    init, step = lora.make_lora_train_step(base_t, cfg, lora.LoRASpec(rank=rank, alpha=alpha), attention_backend="plain",
                                           optimizer_spec=_optimizer(opt_kw), base_specs=base_specs)
    state = init(mine)
    losses = []
    tb = {k: _t(v) for k, v in batch.items()}
    with _ctx(mesh):
        for ts, noise in draws:
            mine, state, loss = step(mine, state, tb, timesteps=torch.from_numpy(ts), noise=_t(noise))
            losses.append(loss.item())
    sharded = sum(int(p.data_dim is not None) for blk in (base_specs or {}).get("blocks", [])
                  for grp in blk.values() for leaf in grp.values() for p in leaf.values())
    return {"losses": losses, "lora": {n: {k: _np(v) for k, v in ab.items()} for n, ab in mine.items()},
            "sharded_leaves": sharded}


def case_full(mesh, base, batch, draws, opt_kw, ema_decay=0.0, min_size=2 ** 10):
    """Full fine-tuning's step, one per draw, sharded over the mesh; the
    params and the EMA come back whole (gathered)."""
    from s2v_torch.config import TransformerConfig
    from s2v_torch.loaders.jax_params import transformer_from_jax
    from s2v_torch.parallel.sharding import gather_params
    from s2v_torch.training.full import floating_leaves, make_full_train_step

    cfg = TransformerConfig.tiny()
    prep, init, step = make_full_train_step(cfg, optimizer_spec=_optimizer(opt_kw), attention_backend="plain",
                                            mesh=mesh, ema_decay=ema_decay, fsdp_min_size=min_size)
    params = prep(transformer_from_jax(base, cfg, device="cpu"), dtype=torch.float32)
    state = init(params)
    tb = {k: _t(v) for k, v in batch.items()}
    losses = []
    for ts, noise in draws:
        params, state, loss = step(params, state, tb, timesteps=torch.from_numpy(ts), noise=_t(noise))
        losses.append(loss.item())
    out = {"losses": losses, "params": [_np(x) for x in floating_leaves(gather_params(params, mesh, prep.specs))]}
    if ema_decay:
        out["ema"] = [_np(x) for x in floating_leaves(gather_params(state[1], mesh, prep.specs))]
    return out


def case_state(mesh, base, out_dir, other):
    """A sharded full-mode train state saved and read back on its mesh, and
    the errors of reading it on the mesh ``other`` and with no mesh."""
    from s2v_torch.config import TransformerConfig
    from s2v_torch.loaders.jax_params import transformer_from_jax
    from s2v_torch.loaders.train_state import load_train_state, save_train_state
    from s2v_torch.training.full import make_full_train_step, state_placements
    from s2v_torch.training.optim import OptimizerSpec

    cfg = TransformerConfig.tiny()
    prep, init, _ = make_full_train_step(cfg, optimizer_spec=OptimizerSpec(), mesh=mesh, ema_decay=0.5,
                                         fsdp_min_size=2 ** 10)
    params = prep(transformer_from_jax(base, cfg, device="cpu"), dtype=torch.float32)
    state = {"params": params, "opt_state": init(params), "step": 3}
    path = save_train_state(state, os.path.join(out_dir, "train_state_3"), mesh=mesh,
                            placements=state_placements(prep.specs, True))
    back = load_train_state(path, state, mesh=mesh)

    def same(a, b):
        if isinstance(a, dict):
            return all(same(a[k], b[k]) for k in a)
        if isinstance(a, (list, tuple)):
            return all(same(x, y) for x, y in zip(a, b))
        return torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b

    errors = {}
    for name, where in (("other", _mesh(other)), ("none", None)):
        try:
            load_train_state(path, state, mesh=where)
            errors[name] = ""
        except ValueError as e:
            errors[name] = str(e)
    files = sorted(os.listdir(path))
    return {"equal": same(state, back), "errors": errors, "files": files}


def case_generate(mesh, tp, vp, inputs, backend="plain", grad_forward=None):
    """``S2VPipeline.generate`` to latents after ``set_mesh`` (the DiT
    sliced over ``model``) and ``set_attention(backend)``; with
    ``grad_forward`` (a batch size), also the error of a forward under
    autograd on that many rows (C.32: the refusal stays there)."""
    from s2v_torch.config import TransformerConfig, VAEConfig
    from s2v_torch.loaders.jax_params import transformer_from_jax, vae_from_jax
    from s2v_torch.models.transformer import transformer_forward
    from s2v_torch.pipelines.s2v import S2VPipeline

    tcfg = TransformerConfig.tiny()
    vcfg = VAEConfig.tiny(latent_channels=4, sample_height=64, sample_width=64)
    pipe = S2VPipeline(transformer_params=transformer_from_jax(tp, tcfg, device="cpu"), transformer_cfg=tcfg,
                       vae_params=vae_from_jax(vp, vcfg, device="cpu"), vae_cfg=vcfg, device="cpu")
    pipe.set_mesh(mesh)
    pipe.set_attention(backend)
    latents, ref, embeds, common = inputs
    got = pipe.generate(latents=_t(latents), ref_latents=_t(ref), prompt_embeds=_t(embeds), **common)
    out = {"latents": _np(got), "stats": dict(pipe.stats)}
    if grad_forward:
        b = grad_forward
        video = torch.zeros(b, *latents.shape[1:], requires_grad=True)
        try:
            with _ctx(mesh):
                transformer_forward(pipe.transformer_params, tcfg, video, _t(ref).expand(b, *ref.shape[1:]),
                                    torch.zeros(b, tcfg.max_text_seq_length, tcfg.text_embed_dim),
                                    torch.full((b,), 500), attention_backend=backend)
            out["grad_error"] = ""
        except ValueError as e:
            out["grad_error"] = str(e)
    return out


def case_hybrid(mesh, dcn, ici, local_world_size):
    """``make_hybrid_mesh`` with ``LOCAL_WORLD_SIZE`` ranks a host: its dim
    names and this rank's coordinates, or the error it raises."""
    from s2v_torch.parallel import make_hybrid_mesh

    os.environ["LOCAL_WORLD_SIZE"] = str(local_world_size)
    try:
        hybrid = make_hybrid_mesh(dcn, ici, "cpu")
    except ValueError as e:
        return {"error": str(e)}
    finally:
        del os.environ["LOCAL_WORLD_SIZE"]
    return {"names": list(hybrid.mesh_dim_names), "coords": list(hybrid.get_coordinate()),
            "shape": list(hybrid.mesh.shape), "rank": torch.distributed.get_rank()}


CASES = {"hybrid": case_hybrid, "forward": case_forward, "heads": case_heads, "t5": case_t5, "lora": case_lora, "full": case_full,
         "state": case_state, "generate": case_generate}
_MESHES = {}


def _mesh(spec):
    """The ``DeviceMesh`` of a spec over the whole group, made once a spec."""
    from torch.distributed.device_mesh import init_device_mesh

    from s2v_torch.parallel.sharding import parse_mesh_spec

    if spec not in _MESHES:
        sizes = parse_mesh_spec(spec)
        _MESHES[spec] = init_device_mesh("cpu", tuple(sizes.values()), mesh_dim_names=tuple(sizes))
    return _MESHES[spec]


def _rank_main(rank, world_size, cases, out_dir):
    torch.set_num_threads(2)
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(out_dir, "store"), world_size), rank=rank,
                            world_size=world_size, timeout=timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    try:
        results = {name: CASES[kind](_mesh(spec), **kwargs) for name, (kind, spec, kwargs) in cases.items()}
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)


def run_mesh_ranks(world_size, cases, out_dir, timeout_s=150):
    """Spawn ``world_size`` ranks that run ``cases`` (``{name: (kind, mesh
    spec, kwargs)}``, kinds from :data:`CASES`); returns a list of each
    rank's ``{name: result}``.  Raises when a rank fails or the ranks
    outlive ``timeout_s``."""
    import torch.multiprocessing as mp

    os.makedirs(out_dir, exist_ok=True)
    ctx = mp.start_processes(_rank_main, args=(world_size, cases, str(out_dir)), nprocs=world_size, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + timeout_s
    while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
        if time.monotonic() >= deadline:
            for proc in ctx.processes:
                proc.kill()
            raise TimeoutError(f"{world_size} mesh ranks did not finish within {timeout_s} s")
    out = []
    for rank in range(world_size):
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out
