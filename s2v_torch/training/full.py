"""The v-prediction objective and full fine-tuning (counterpart of
``s2v_tpu/training/full.py``: ``vpred_loss``, ``make_full_train_step``,
with its FSDP).

Every transformer parameter trains: fp32 master weights, an optional bf16
(or fp16) forward through ``compute_dtype``, the trainers' optimizer, and an
optional EMA of the weights.  On a mesh with a ``data`` or ``model`` dim (of
any size) the tree is sharded as JAX's specs shard it
(``parallel/sharding.py``: ``fsdp_param_specs`` over ``data``,
megatron slices over ``model``, ``combined_param_specs`` for both): each
rank keeps only its shards of the params, gradients, optimizer state and
EMA; each block's shards are all-gathered over ``data`` in the compute dtype
just before the block runs (again in the backward under remat), and the
gradient goes back to its owner's shard.  The clip norm and prodigy's
d-estimate add every rank's shards (``_global_sum``), so every rank steps
alike.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Dict, List, Optional, Union

import torch

from s2v_torch.config import SchedulerConfig, TransformerConfig
from s2v_torch.models.transformer import transformer_forward
from s2v_torch.ops.attention import resolve_attention_backend
from s2v_torch.parallel.context import data_parallel, default_logical_map, mesh_context, sum_grads, sum_grads_over_seq
from s2v_torch.parallel.sharding import (
    FSDP_MIN_SIZE,
    ParamGather,
    combined_param_specs,
    fsdp_param_specs,
    mesh_sizes,
    shard_params,
    spec_at,
    transformer_param_specs_like,
)
from s2v_torch.schedulers.ddim import add_noise, compute_alphas_cumprod, get_velocity
from s2v_torch.utils.logging import phase, span_device


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
    param_gather=None,
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
    ``cfg.dtype``, so the two must agree.

    On a ``seq`` ring (a sequence-parallel backend under a mesh context)
    every rank computes its video frames and the loss over the gathered
    prediction, and a param's gradient on a rank is that rank's share: the
    caller sums them over the ring (``parallel/context.py``
    ``sum_grads_over_seq``).  So on a ``data`` dim: every rank draws the
    whole batch's timesteps and noise, runs its rows, and computes the loss
    over the gathered prediction, the mean over the global batch; the
    gradients are shares summed over ``data``.  ``param_gather``: FSDP's
    per-block gather (``transformer_forward``)."""
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
        pos_embedding=batch.get("pos_embedding"), param_gather=param_gather,
    )
    return torch.mean(torch.square(pred.float() - target.float()))


def floating_leaves(tree) -> List[torch.Tensor]:
    """The floating tensors of a nested dict/list/tuple tree, in its order."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in floating_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in floating_leaves(v)]
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return [tree]
    return []


def _copy_floating(tree, dtype: Optional[torch.dtype] = None):
    """A copy of the tree with every floating tensor copied (cast to
    ``dtype`` when given): the optimizer updates it in place, so it must not
    alias the tree it came from."""
    if isinstance(tree, dict):
        return {k: _copy_floating(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_copy_floating(v, dtype) for v in tree)
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return tree.detach().to(dtype=dtype or tree.dtype, copy=True)
    return tree


def full_param_specs(params, mesh, min_size: int = FSDP_MIN_SIZE) -> dict:
    """The placements full fine-tuning gives the tree on ``mesh``: FSDP over
    ``data``, megatron slices over ``model``, both when both are named."""
    sizes = mesh_sizes(mesh)
    if "data" in sizes and "model" in sizes:
        return combined_param_specs(params, sizes["data"], sizes["model"], min_size)
    if "data" in sizes:
        return fsdp_param_specs(params, sizes["data"], min_size)
    return transformer_param_specs_like(params)


def floating_specs(params, specs) -> list:
    """The placements of :func:`floating_leaves` ``(params)``, in its order."""
    if isinstance(params, dict):
        return [p for k, v in params.items() for p in floating_specs(v, specs[k])]
    if isinstance(params, (list, tuple)):
        return [p for v, sp in zip(params, specs) for p in floating_specs(v, sp)]
    if isinstance(params, torch.Tensor) and params.is_floating_point():
        return [specs]
    return []


def _global_sum(specs: list, mesh):
    """The optimizer's ``global_sum`` over a sharded tree: each leaf's sum
    all-reduced over ``data`` when it is sharded there and over ``model``
    when it is sliced there (a replicated leaf counts once), then added in
    leaf order, so a one-rank mesh adds exactly what one card adds."""
    names = mesh.mesh_dim_names or ()
    masks = [(mesh.get_group(dim), [getattr(p, attr) is not None for p in specs])
             for dim, attr in (("data", "data_dim"), ("model", "model_dim")) if dim in names]

    def total(values):
        v = torch.stack(values)
        for group, mask in masks:
            summed = v.clone()
            torch.distributed.all_reduce(summed, group=group)
            v = torch.where(torch.as_tensor(mask, device=v.device), summed, v)
        return sum(v.unbind())

    return total


def _mesh_device(mesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def state_placements(specs, ema: bool) -> Dict[str, dict]:
    """Each sharded tensor of full mode's train state ``{"params",
    "opt_state", "step"}`` by its name in ``loaders/train_state.py``, with
    its placement: the params, the EMA tree, and the optimizer's per-leaf
    lists (moments, prodigy's sums, the accumulator)."""
    named = []

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{path}/{k}")
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{path}/{i}")
        else:
            named.append((path, node.to_json()))

    walk(specs, "")
    inner = "opt_state/0" if ema else "opt_state"
    out = {}
    for i, (path, p) in enumerate(named):
        out[f"params{path}"] = p
        if ema:
            out[f"opt_state/1{path}"] = p
        for key in ("mu", "nu", "exp_avg", "exp_avg_sq", "grad_sum", "params0", "acc"):
            out[f"{inner}/{key}/{i}"] = p
    return out


def make_full_train_step(
    cfg: TransformerConfig,
    scheduler_cfg: Optional[SchedulerConfig] = None,
    optimizer_spec=None,
    attention_backend: str = "auto",
    remat: Union[bool, str] = True,
    mesh=None,
    compute_dtype: Optional[torch.dtype] = None,
    ema_decay: float = 0.0,
    fsdp_min_size: int = FSDP_MIN_SIZE,
):
    """Returns ``(prepare, init_opt_state, train_step)``
    (``s2v_tpu/training/full.py:153-280``):

    * ``prepare(params, dtype=None)``: a copy of the tree, its floating
      tensors cast to ``dtype`` (the fp32 master weights of a bf16
      checkpoint); the copy is what trains, in place.  On a sharded mesh
      (below) the copy is this rank's shards, each sliced from ``params``
      (on the host or the card) before it is cast and moved to the mesh's
      device, so the cast tree is never whole on one card; ``prepare.specs``
      then holds their placements (:func:`full_param_specs`);
    * ``init_opt_state(params)``: the optimizer's state over the floating
      leaves, and with ``ema_decay > 0`` the pair ``(state, ema)``, the EMA
      tree starting at a copy of the params;
    * ``params, opt_state, loss = train_step(params, opt_state, batch,
      generator=None, timesteps=None, noise=None)``: the loss of
      :func:`vpred_loss` (its test hooks too), its gradients over every
      floating leaf, the optimizer's update in place; the EMA moves, ``e =
      e·decay + w·(1 − decay)``, only on the accumulation boundary (after an
      update, ``mini_step == 0``), as JAX folds it into the decay.

    ``compute_dtype`` (e.g. ``torch.bfloat16``) casts the floating params for
    the forward, which then computes in that type; without it the forward
    computes in the params' own type.  ``attention_backend`` ``"auto"`` is
    ``flash`` on CUDA, ``plain`` on the CPU.

    ``mesh`` (a ``DeviceMesh``) with a ``data`` or ``model`` dim, of any
    size (JAX shards above 1 only, ``use_fsdp``; the results are the same,
    ROADMAP C.30): FSDP and megatron TP as the module doc says, the step
    running under the mesh's context.  Every rank passes the same whole
    batch and draws; each runs its rows of a ``data`` dim and ends with the
    same loss.  A mesh of a ``seq`` dim only is sequence parallelism (the
    caller enters its context; the tree stays whole).  Temporal patches
    (``cfg.patch_size_t``) raise: the trainer's data and loss are per latent
    frame."""
    from s2v_torch.training.optim import OptimizerSpec, make_optimizer

    cfg.require_frame_patches("the full trainer")

    sizes = mesh_sizes(mesh)
    sharded = "data" in sizes or "model" in sizes
    if sharded and (mesh is None or isinstance(mesh, dict)):
        raise ValueError(f"FSDP and megatron sharding need a DeviceMesh (parallel/sharding.py::make_mesh), "
                         f"not the sizes {sizes}")
    if not 0.0 <= ema_decay < 1.0:
        raise ValueError(f"ema_decay must be in [0, 1), got {ema_decay}")
    alphas_np = compute_alphas_cumprod(scheduler_cfg or SchedulerConfig())
    tx = make_optimizer(optimizer_spec or OptimizerSpec())

    def prepare(params, dtype: Optional[torch.dtype] = None):
        if not sharded:
            return _copy_floating(params, dtype)
        prepare.specs = full_param_specs(params, mesh, fsdp_min_size)
        tx.global_sum = _global_sum(floating_specs(params, prepare.specs), mesh)
        return shard_params(params, mesh, prepare.specs, dtype=dtype, device=_mesh_device(mesh))

    prepare.specs = None

    def loss_tree(params):
        """The tree the loss reads, its leaves' gradients summed over the
        dims where they are shares, and FSDP's gather."""
        if not sharded:
            return sum_grads_over_seq(params), None
        specs = prepare.specs
        if specs is None:
            raise ValueError("call prepare(params) before the sharded train step: it places the shards")
        tree = sum_grads(params, where=lambda path: ("sp",) if spec_at(specs, path).data_dim is not None
                         else ("sp", "dp"))
        dp = data_parallel()
        return tree, (ParamGather(specs, dp) if dp is not None else None)

    def init_opt_state(params):
        state = tx.init(floating_leaves(params))
        return (state, _copy_floating(params)) if ema_decay > 0.0 else state

    def train_step(params, opt_state, batch, generator=None, timesteps=None, noise=None):
        if not sharded:
            return _train_step(params, opt_state, batch, generator, timesteps, noise)
        with mesh_context(mesh, default_logical_map(mesh)):
            return _train_step(params, opt_state, batch, generator, timesteps, noise)

    def _train_step(params, opt_state, batch, generator, timesteps, noise):
        leaves = floating_leaves(params)
        device = leaves[0].device
        with span_device(device), phase("s2v.train.step"):
            inner, ema = opt_state if ema_decay > 0.0 else (opt_state, None)
            fwd_cfg = replace(cfg, dtype=compute_dtype or leaves[0].dtype)
            with phase("s2v.sync.to_device"):  # the scheduler's table, from the host
                alphas = torch.as_tensor(alphas_np, device=device)
            backend = resolve_attention_backend(attention_backend, device)
            for x in leaves:
                x.requires_grad_(True)
            try:
                with phase("s2v.train.forward"):
                    tree, gather = loss_tree(params)
                    loss = vpred_loss(tree, fwd_cfg, batch, alphas, generator, attention_backend=backend,
                                      remat=remat, compute_dtype=compute_dtype, timesteps=timesteps, noise=noise,
                                      param_gather=gather)
                with phase("s2v.train.backward"):  # remat's recompute runs in here
                    grads = torch.autograd.grad(loss, leaves)
            finally:
                for x in leaves:
                    x.requires_grad_(False)
            with phase("s2v.train.optimizer"):
                tx.step(leaves, grads, inner)
                if ema is not None and inner.get("mini_step", 0) == 0:
                    with torch.no_grad():
                        for e, w in zip(floating_leaves(ema), leaves):
                            e.copy_(e * ema_decay + w.to(e.dtype) * (1.0 - ema_decay))
            return params, ((inner, ema) if ema is not None else inner), loss.detach()

    return prepare, init_opt_state, train_step
