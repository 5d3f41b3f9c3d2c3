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
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from s2v_torch.config import SchedulerConfig, TransformerConfig
from s2v_torch.ops.attention import resolve_attention_backend
from s2v_torch.schedulers.ddim import compute_alphas_cumprod
from s2v_torch.training.optim import OptimizerSpec, make_optimizer

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
    # the intended enable_lora semantics (modulation adapters on the ref
    # stream only) need the disentangled adaLN mode, which is not ported yet
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
    if spec.disentangled:
        raise NotImplementedError("disentangled LoRA needs the base_linear adaLN mode, which is not ported yet")


def init_lora_params(generator: torch.Generator, base_params: dict, spec: LoRASpec,
                     dtype: torch.dtype = torch.float32) -> dict:
    """A ~ N(0, 1/r), B = 0, so the adapted model starts exactly at the base
    model.  Made on ``generator``'s device, which must be the params'."""
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
    base tree is not modified; gradients reach a and b)."""
    if base_is_quantized(base_params):
        raise ValueError(
            "merge_lora_params needs a bf16/fp32 base (int8 kernels cannot absorb a merge); QLoRA adapters are "
            "applied after the linear through the runtime factor tree, see lora_loss_fn")
    _check_supported(base_params, spec)
    merged = dict(base_params)
    merged["blocks"] = [dict(layer) for layer in base_params["blocks"]]
    for name, ab in lora_params.items():
        (group, leaf_name), per_layer = _TARGETS[name]
        owners = merged["blocks"] if per_layer else [merged]
        for i, owner in enumerate(owners):
            a, b = (ab["a"][i], ab["b"][i]) if per_layer else (ab["a"], ab["b"])
            owner[group] = dict(owner[group])
            leaf = owner[group][leaf_name]
            delta = (a @ b) * spec.scale
            owner[group][leaf_name] = {**leaf, "weight": leaf["weight"] + delta.T.to(leaf["weight"].dtype)}
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
) -> torch.Tensor:
    """v-prediction MSE with the adapters applied through the runtime factor
    tree, factors cast to ``cfg.dtype`` inside the loss.  ``timesteps`` and
    ``noise`` are the test hooks of :func:`vpred_loss`."""
    from s2v_torch.models.transformer import RUNTIME_LORA_KEY
    from s2v_torch.training.full import vpred_loss

    _check_supported(base_params, spec)
    params = dict(base_params)
    params[RUNTIME_LORA_KEY] = _runtime_tree(lora_params, spec, cfg.dtype)
    return vpred_loss(params, cfg, batch, alphas_cumprod, generator, attention_backend=attention_backend,
                      remat=remat, timesteps=timesteps, noise=noise)


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
):
    """Returns ``(init_opt_state, train_step)`` with
    ``lora, opt_state, loss = train_step(lora, opt_state, batch, generator)``.

    ``attention_backend`` ``"auto"`` is ``flash`` on CUDA (B1 forward, B2
    backward) and ``plain`` on the CPU.  ``"sp_windowed"`` (B6/B1 forward,
    B7/B2 backward) needs the step to run under a mesh context with a
    ``seq`` dim (``s2v_torch.parallel.mesh_context``, as ``S2VPipeline``
    enters it); every rank passes the same batch and draws and computes the
    same loss and gradients.  ``remat`` (default on) checkpoints
    each block.  ``optimizer_spec`` selects the reference-template optimizer
    surface; without it, adamw at ``learning_rate`` with optax's defaults
    (b2 0.999, weight decay 1e-4).  The step updates the adapters and the
    optimizer state in place and returns them; the base params get no
    gradient and do not change.  ``train_step`` also takes ``timesteps=``
    and ``noise=`` (the test hooks of :func:`vpred_loss`)."""
    _check_supported(base_params, spec)
    device = _target_weight(base_params, "qkv").device
    backend = resolve_attention_backend(attention_backend, device)
    alphas = torch.as_tensor(compute_alphas_cumprod(scheduler_cfg or SchedulerConfig()), device=device)
    tx = make_optimizer(optimizer_spec or OptimizerSpec(learning_rate=learning_rate, beta2=0.999))

    def init_opt_state(lora_params: dict) -> dict:
        return tx.init(lora_leaves(lora_params))

    def train_step(lora_params, opt_state, batch, generator=None, timesteps=None, noise=None):
        leaves = lora_leaves(lora_params)
        for t in leaves:
            t.requires_grad_(True)
        loss = lora_loss_fn(lora_params, base_params, cfg, spec, batch, alphas, generator, backend, remat,
                            timesteps=timesteps, noise=noise)
        grads = torch.autograd.grad(loss, leaves)
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
