"""LoRA fine-tuning of the 3-stream DiT (counterpart of
``s2v_tpu/training/lora.py``).

Adapters of rank r and scale alpha/r on the reference's target families
(attention projections, patch embedding, text projection, both adaLN
modulation linears, ff.net.2), trained with the v-prediction objective on
the frozen base model.  The adapters live in their own tree in the JAX
package's layout, per target ``{"a": [L, in, r], "b": [L, r, out]}`` (no
``L`` for ``patch_proj``/``text_proj``), fp32.  The loss applies them per
layer inside the block loop through the runtime factor tree
(``s2v_torch.models.transformer.RUNTIME_LORA_KEY``), so gradients reach only
``a`` and ``b`` and no second weight tree is built.

QLoRA: on an int8 base (``s2v_torch.ops.quant.quantize_transformer_params``)
the adapters ride the same runtime tree, applied after the frozen int8
linears, whose straight-through backward carries the gradient to the layers
below.  An int8 base cannot take a merge, so ``merge_lora_params`` and the
disentangled mode refuse one.

Disentangled LoRA (``LoRASpec.disentangled``, the reference's intended
``enable_lora`` semantics): the loss merges the adapters into a functional
copy of the weights and keeps each block's pre-merge adaLN linears beside
the adapted ones (``base_linear``), so the modulation adapters act on the
ref stream only (``s2v_tpu/training/lora.py:134-141, 239-249``).

Across cards (``s2v_tpu/training/lora.py:20-21``, ``s2v_tpu/train.py:484-525``),
the step runs under a mesh context: the adapters and their optimizer are
whole on every rank; a ``data`` dim splits the batch, and the adapters'
gradients, each rank's share, are summed there (and over a ``seq`` ring);
on a ``model`` dim the base is sliced for megatron TP
(``S2VPipeline.set_mesh``), each block's adapter delta is sliced as its
kernel, and the per-layer adapters' gradients, partial over ``model``, are
summed there too; ``base_specs`` (``--fsdp_base``) says how the frozen base
is sharded over ``data`` (``parallel/sharding.py::fsdp_param_specs``), and
each block's shards are gathered before it runs.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from s2v_torch.config import SchedulerConfig, TransformerConfig
from s2v_torch.ops.attention import resolve_attention_backend
from s2v_torch.parallel.context import data_parallel, sum_grads, tensor_parallel
from s2v_torch.parallel.sharding import ParamGather, take_slice, tp_leaf_placement
from s2v_torch.schedulers.ddim import compute_alphas_cumprod
from s2v_torch.training.optim import OptimizerSpec, make_optimizer
from s2v_torch.utils.logging import phase, span_device

# target -> (where its weight lives, whether it is per layer)
_TARGETS = {
    "qkv": (("attn", "qkv"), True),  # covers to_q/to_k/to_v (fused)
    "to_out": (("attn", "to_out"), True),
    "norm1.linear": (("norm1", "linear"), True),
    "norm2.linear": (("norm2", "linear"), True),
    "ff.net.2": (("ff", "net_2"), True),
    "patch_proj": (("patch_embed", "proj"), False),
    "text_proj": (("patch_embed", "text_proj"), False),
}
_TOP_TARGETS = ("patch_proj", "text_proj")


@dataclass(frozen=True)
class LoRASpec:
    rank: int = 128
    alpha: float = 64.0
    targets: Tuple[str, ...] = tuple(_TARGETS.keys())
    # the intended enable_lora semantics: the norm1/norm2 modulation adapters
    # apply to the ref stream only, video and text keep the base modulation
    # (the model runs with disentangled_modulation)
    disentangled: bool = False

    @property
    def scale(self) -> float:
        return self.alpha / self.rank


def _leaf(tree: dict, path) -> dict:
    for key in path:
        tree = tree[key]
    return tree


def _target_weight(base_params: dict, name: str) -> torch.Tensor:
    """The target's ``[out, in]`` weight, or its int8 ``q`` on a QLoRA base
    (the first layer's for a per-layer target)."""
    path, per_layer = _TARGETS[name]
    leaf = _leaf(base_params["blocks"][0] if per_layer else base_params, path)
    return leaf["q" if "q" in leaf else "weight"]


def base_is_quantized(base_params: dict) -> bool:
    """True when the transformer tree carries int8 kernels (a QLoRA base)."""
    blocks = base_params.get("blocks") or [{}]
    return "q" in blocks[0].get("attn", {}).get("qkv", {})


def _check_supported(base_params: dict, spec: LoRASpec) -> None:
    if spec.disentangled and base_is_quantized(base_params):
        raise ValueError(
            "disentangled LoRA needs a bf16/fp32 base (it merges modulation kernels and keeps the pre-merge "
            "base_linear beside them, which int8 kernels cannot express); train it on the unquantized tree")


def init_lora_params(generator: torch.Generator, base_params: dict, spec: LoRASpec,
                     dtype: torch.dtype = torch.float32) -> dict:
    """A ~ N(0, 1/r), B = 0, so the adapted model starts exactly at the base
    model.  Made on ``generator``'s device, which must be the params'.
    ``base_params`` is the whole tree (the shapes are read from it), not a
    rank's slices."""
    _check_supported(base_params, spec)
    num_layers = len(base_params["blocks"])
    lora = {}
    for name in spec.targets:
        d_out, d_in = _target_weight(base_params, name).shape
        lead = () if name in _TOP_TARGETS else (num_layers,)
        device = generator.device
        a = torch.randn((*lead, d_in, spec.rank), generator=generator, device=device, dtype=dtype)
        lora[name] = {"a": a / np.sqrt(spec.rank),
                      "b": torch.zeros((*lead, spec.rank, d_out), device=device, dtype=dtype)}
    return lora


def merge_lora_params(base_params: dict, lora_params: dict, spec: LoRASpec) -> dict:
    """A new tree with ``weight + (scale · a @ b)ᵀ`` at each target (the
    base tree is not modified; gradients reach a and b).  With
    ``spec.disentangled`` each adapted norm1/norm2 ``linear`` gets its
    pre-merge weights beside it as ``base_linear``."""
    if base_is_quantized(base_params):
        raise ValueError(
            "merge_lora_params needs a bf16/fp32 base (int8 kernels cannot absorb a merge); QLoRA adapters are "
            "applied after the linear through the runtime factor tree, see lora_loss_fn")
    _check_supported(base_params, spec)
    merged = dict(base_params)
    merged["blocks"] = [dict(layer) for layer in base_params["blocks"]]
    tp = tensor_parallel()
    for name, ab in lora_params.items():
        (group, leaf_name), per_layer = _TARGETS[name]
        owners = merged["blocks"] if per_layer else [merged]
        placement = tp_leaf_placement(("blocks", "0", group, leaf_name, "weight"), 2) if per_layer else None
        for i, owner in enumerate(owners):
            a, b = (ab["a"][i], ab["b"][i]) if per_layer else (ab["a"], ab["b"])
            owner[group] = dict(owner[group])
            leaf = owner[group][leaf_name]
            delta = (a @ b) * spec.scale
            if tp is not None and placement is not None and placement.model_dim is not None:
                # the whole delta sliced as the kernel is (a model rank's base holds its slices)
                delta = take_slice(delta, 1 - placement.model_dim, placement.blocks, tp.rank, tp.size, name)
            owner[group][leaf_name] = {**leaf, "weight": leaf["weight"] + delta.T.to(leaf["weight"].dtype)}
            if spec.disentangled and name in ("norm1.linear", "norm2.linear"):
                owner[group]["base_linear"] = {"weight": leaf["weight"], "bias": leaf["bias"]}
    return merged


def _runtime_tree(lora_params: dict, spec: LoRASpec, dtype: torch.dtype) -> dict:
    blocks: Dict[str, dict] = {}
    top: Dict[str, dict] = {}
    for name, ab in lora_params.items():
        # compute-dtype factors inside the loss; the fp32 master copy is what
        # the optimizer updates, and the cast hands back fp32 grads
        pair = {"a": (ab["a"] * spec.scale).to(dtype), "b": ab["b"].to(dtype)}
        (top if name in _TOP_TARGETS else blocks)[name] = pair
    tree = {}
    if blocks:
        tree["blocks"] = blocks
    if top:
        tree["top"] = top
    return tree


def lora_loss_fn(
    lora_params: dict,
    base_params: dict,
    cfg: TransformerConfig,
    spec: LoRASpec,
    batch: Dict[str, torch.Tensor],
    alphas_cumprod: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    attention_backend: str = "plain",
    remat: Union[bool, str] = True,
    timesteps: Optional[torch.Tensor] = None,
    noise: Optional[torch.Tensor] = None,
    param_gather=None,
) -> torch.Tensor:
    """v-prediction MSE with the adapters applied through the runtime factor
    tree, factors cast to ``cfg.dtype`` inside the loss; with
    ``spec.disentangled`` through :func:`merge_lora_params` instead (the
    pre-merge modulation linears beside the merged ones; ``cfg`` needs
    ``disentangled_modulation``, which :func:`make_lora_train_step` sets).
    ``timesteps`` and ``noise`` are the test hooks of :func:`vpred_loss`,
    ``param_gather`` its FSDP gather of the base.

    Under a mesh context the adapters' gradients come out whole on every
    rank: summed over ``seq`` (above one rank) and ``data``, where they are
    each rank's share, and, for the per-layer adapters, whose delta is
    sliced as the kernel, over ``model``."""
    from s2v_torch.models.transformer import RUNTIME_LORA_KEY
    from s2v_torch.training.full import vpred_loss

    _check_supported(base_params, spec)
    lora_params = sum_grads(lora_params, where=lambda path: ("sp", "dp") if path[0] in _TOP_TARGETS
                            else ("sp", "dp", "tp"))
    if spec.disentangled:
        params = merge_lora_params(base_params, lora_params, spec)
    else:
        params = dict(base_params)
        params[RUNTIME_LORA_KEY] = _runtime_tree(lora_params, spec, cfg.dtype)
    return vpred_loss(params, cfg, batch, alphas_cumprod, generator, attention_backend=attention_backend,
                      remat=remat, timesteps=timesteps, noise=noise, param_gather=param_gather)


def lora_leaves(lora_params: dict) -> list:
    """The adapter tensors in a fixed order (target, then a before b)."""
    return [lora_params[name][k] for name in sorted(lora_params) for k in ("a", "b")]


def make_lora_train_step(
    base_params: dict,
    cfg: TransformerConfig,
    spec: LoRASpec,
    scheduler_cfg: Optional[SchedulerConfig] = None,
    learning_rate: float = 1e-4,
    attention_backend: str = "auto",
    remat: Union[bool, str] = True,
    optimizer_spec: Optional[OptimizerSpec] = None,
    base_specs: Optional[dict] = None,
):
    """Returns ``(init_opt_state, train_step)`` with
    ``lora, opt_state, loss = train_step(lora, opt_state, batch, generator)``.

    ``attention_backend`` ``"auto"`` is ``flash`` on CUDA (B1 forward, B2
    backward) and ``plain`` on the CPU.  A sequence-parallel backend
    (``sp_allgather``, ``sp_ulysses``, ``ring``, ``sp_windowed``) needs the
    step to run under a mesh context with a ``seq`` dim
    (``s2v_torch.parallel.mesh_context``); every rank passes the same batch
    and draws, computes its frames, and ends with the same loss and the
    gradients summed over the ring.  ``remat`` (default on) checkpoints
    each block.  ``optimizer_spec`` selects the reference-template optimizer
    surface; without it, adamw at ``learning_rate`` with optax's defaults
    (b2 0.999, weight decay 1e-4).  The step updates the adapters and the
    optimizer state in place and returns them; the base params get no
    gradient and do not change.  ``train_step`` also takes ``timesteps=``
    and ``noise=`` (the test hooks of :func:`vpred_loss`).  A disentangled
    ``spec`` runs the model with ``disentangled_modulation``.

    Under a mesh context with a ``data`` or ``model`` dim (see the module
    doc) every rank passes the same whole batch and draws and ends with the
    same loss and adapters.  ``base_specs``: the placements of a base
    sharded over ``data`` (``--fsdp_base``), gathered per block; the step
    then needs a ``data`` dim in the active mesh."""
    _check_supported(base_params, spec)
    if spec.disentangled and not cfg.disentangled_modulation:
        cfg = replace(cfg, disentangled_modulation=True)
    device = _target_weight(base_params, "qkv").device
    backend = resolve_attention_backend(attention_backend, device)
    alphas = torch.as_tensor(compute_alphas_cumprod(scheduler_cfg or SchedulerConfig()), device=device)
    tx = make_optimizer(optimizer_spec or OptimizerSpec(learning_rate=learning_rate, beta2=0.999))

    def init_opt_state(lora_params: dict) -> dict:
        return tx.init(lora_leaves(lora_params))

    def train_step(lora_params, opt_state, batch, generator=None, timesteps=None, noise=None):
        with span_device(device), phase("s2v.train.step"):
            gather = None
            if base_specs is not None:
                dp = data_parallel()
                if dp is None:
                    raise ValueError("a base sharded over data (base_specs) needs a mesh context with a data dim")
                gather = ParamGather(base_specs, dp)
            leaves = lora_leaves(lora_params)
            for t in leaves:
                t.requires_grad_(True)
            with phase("s2v.train.forward"):
                loss = lora_loss_fn(lora_params, base_params, cfg, spec, batch, alphas, generator, backend, remat,
                                    timesteps=timesteps, noise=noise, param_gather=gather)
            with phase("s2v.train.backward"):  # remat's recompute runs in here
                grads = torch.autograd.grad(loss, leaves)
            with phase("s2v.train.optimizer"):
                tx.step([t.detach() for t in leaves], grads, opt_state)
            return lora_params, opt_state, loss.detach()

    return init_opt_state, train_step


def runtime_tree_from_training(lora_params: dict, spec: LoRASpec) -> dict:
    """Trainer factor tree -> the inference runtime-LoRA layout (numpy, fp32,
    scale folded into ``a``)."""
    blocks, top = {}, {}
    for name, ab in lora_params.items():
        pair = {"a": _np(ab["a"]) * np.float32(spec.scale), "b": _np(ab["b"])}
        (top if name in _TOP_TARGETS else blocks)[name] = pair
    tree = {}
    if blocks:
        tree["blocks"] = blocks
    if top:
        tree["top"] = top
    return tree


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.detach().float().cpu().numpy()
    return np.asarray(t, np.float32)


def export_lora_to_reference_format(lora_params: dict, spec: LoRASpec, cfg: TransformerConfig) -> dict:
    """Trained adapters as a diffusers-convention state dict
    (``transformer.<module>.lora_A/lora_B.weight``, torch layouts, numpy
    fp32).  The fused qkv adapter splits into to_q/to_k/to_v entries (B's
    columns partition exactly; A is shared)."""
    out = {}
    d = cfg.inner_dim

    def put(module, a, b):
        # ours: a [in, r], b [r, out]; torch: lora_A [r, in], lora_B [out, r]
        out[f"transformer.{module}.lora_A.weight"] = np.ascontiguousarray(a.T)
        out[f"transformer.{module}.lora_B.weight"] = np.ascontiguousarray(b.T)

    for name, ab in lora_params.items():
        a, b = _np(ab["a"]), _np(ab["b"])
        if name == "qkv":
            for i in range(a.shape[0]):
                for j, proj in enumerate(["to_q", "to_k", "to_v"]):
                    put(f"transformer_blocks.{i}.attn1.{proj}", a[i], b[i][:, j * d:(j + 1) * d])
        elif name in ("to_out", "norm1.linear", "norm2.linear", "ff.net.2"):
            hf = {"to_out": "attn1.to_out.0", "norm1.linear": "norm1.linear",
                  "norm2.linear": "norm2.linear", "ff.net.2": "ff.net.2"}[name]
            for i in range(a.shape[0]):
                put(f"transformer_blocks.{i}.{hf}", a[i], b[i])
        elif name == "text_proj":
            put("patch_embed.text_proj", a, b)
        elif name == "patch_proj":
            # matmul form [p*p*C, r] x [r, D]; torch's conv LoRA is
            # A conv [r, C, p, p], B conv [D, r, 1, 1]
            p, c, r = cfg.patch_size, cfg.in_channels, a.shape[-1]
            out["transformer.patch_embed.proj.lora_A.weight"] = np.ascontiguousarray(
                a.reshape(p, p, c, r).transpose(3, 2, 0, 1))
            out["transformer.patch_embed.proj.lora_B.weight"] = np.ascontiguousarray(b.T.reshape(d, r, 1, 1))
    return out
