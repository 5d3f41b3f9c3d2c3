"""The v-prediction objective and full fine-tuning on one card (counterpart
of ``s2v_tpu/training/full.py``: ``vpred_loss``, ``make_full_train_step``).

Every transformer parameter trains: fp32 master weights, an optional bf16
(or fp16) forward through ``compute_dtype``, the trainers' optimizer, and an
optional EMA of the weights.  The JAX package's FSDP and megatron specs
(``fsdp_param_specs``, ``combined_param_specs``) shard over a ``data`` or
``model`` mesh dim, which is ROADMAP A.9: a mesh with such a dim above 1
raises.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Dict, List, Optional, Union

import torch

from s2v_torch.config import SchedulerConfig, TransformerConfig
from s2v_torch.models.transformer import transformer_forward
from s2v_torch.ops.attention import resolve_attention_backend
from s2v_torch.parallel.context import sum_grads_over_seq
from s2v_torch.schedulers.ddim import add_noise, compute_alphas_cumprod, get_velocity


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
    ``cfg.dtype``, so the two must agree.

    On a ``seq`` ring (a sequence-parallel backend under a mesh context)
    every rank computes its video frames and the loss over the gathered
    prediction, and a param's gradient on a rank is that rank's share: the
    caller sums them over the ring (``parallel/context.py``
    ``sum_grads_over_seq``)."""
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


def _mesh_axes(mesh) -> Dict[str, int]:
    """A ``DeviceMesh``'s (or an axes dict's) dim sizes by name."""
    if mesh is None:
        return {}
    if isinstance(mesh, dict):
        return dict(mesh)
    return {name: mesh.size(i) for i, name in enumerate(mesh.mesh_dim_names or ())}


def make_full_train_step(
    cfg: TransformerConfig,
    scheduler_cfg: Optional[SchedulerConfig] = None,
    optimizer_spec=None,
    attention_backend: str = "auto",
    remat: Union[bool, str] = True,
    mesh=None,
    compute_dtype: Optional[torch.dtype] = None,
    ema_decay: float = 0.0,
):
    """Returns ``(prepare, init_opt_state, train_step)`` for one card
    (``s2v_tpu/training/full.py:153-280`` without its FSDP):

    * ``prepare(params, dtype=None)``: a copy of the tree, its floating
      tensors cast to ``dtype`` (the fp32 master weights of a bf16
      checkpoint); the copy is what trains, in place;
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
    ``flash`` on CUDA, ``plain`` on the CPU.  A ``mesh`` (a ``DeviceMesh`` or
    a dict of dim sizes) with a ``data`` or ``model`` dim above 1 asks for
    FSDP or megatron sharding, which raises (ROADMAP A.9)."""
    from s2v_torch.training.optim import OptimizerSpec, make_optimizer

    axes = _mesh_axes(mesh)
    if axes.get("data", 1) > 1 or axes.get("model", 1) > 1:
        raise NotImplementedError(
            f"full fine-tuning over a mesh with a data or model dim above 1 ({axes}) is FSDP / megatron sharding, "
            f"not ported yet (ROADMAP A.9); the port trains every parameter on one card")
    if not 0.0 <= ema_decay < 1.0:
        raise ValueError(f"ema_decay must be in [0, 1), got {ema_decay}")
    alphas_np = compute_alphas_cumprod(scheduler_cfg or SchedulerConfig())
    tx = make_optimizer(optimizer_spec or OptimizerSpec())

    def prepare(params, dtype: Optional[torch.dtype] = None):
        return _copy_floating(params, dtype)

    def init_opt_state(params):
        state = tx.init(floating_leaves(params))
        return (state, _copy_floating(params)) if ema_decay > 0.0 else state

    def train_step(params, opt_state, batch, generator=None, timesteps=None, noise=None):
        inner, ema = opt_state if ema_decay > 0.0 else (opt_state, None)
        leaves = floating_leaves(params)
        device = leaves[0].device
        fwd_cfg = replace(cfg, dtype=compute_dtype or leaves[0].dtype)
        alphas = torch.as_tensor(alphas_np, device=device)
        backend = resolve_attention_backend(attention_backend, device)
        for x in leaves:
            x.requires_grad_(True)
        try:
            loss = vpred_loss(sum_grads_over_seq(params), fwd_cfg, batch, alphas, generator,
                              attention_backend=backend, remat=remat, compute_dtype=compute_dtype,
                              timesteps=timesteps, noise=noise)
            grads = torch.autograd.grad(loss, leaves)
        finally:
            for x in leaves:
                x.requires_grad_(False)
        tx.step(leaves, grads, inner)
        if ema is not None and inner.get("mini_step", 0) == 0:
            with torch.no_grad():
                for e, w in zip(floating_leaves(ema), leaves):
                    e.copy_(e * ema_decay + w.to(e.dtype) * (1.0 - ema_decay))
        return params, ((inner, ema) if ema is not None else inner), loss.detach()

    return prepare, init_opt_state, train_step
