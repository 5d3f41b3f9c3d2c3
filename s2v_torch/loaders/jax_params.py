"""Carry the JAX package's parameters across into the port's layouts.

Each function takes a ``s2v_tpu`` param tree as nested dicts/lists of
**numpy arrays** (``jax.tree.map(np.asarray, params)``) and returns the
port's parameter dict:

  * stacked ``[L, ...]`` block leaves become one dict per layer;
  * ``[in, out]`` linear kernels become ``weight [out, in]`` (``F.linear``);
  * ``DHWIO`` / ``HWIO`` conv kernels become ``OIDHW`` / ``OIHW``;
  * separate ``to_q``/``to_k``/``to_v`` kernels are fused into ``qkv``
    (rows q | k | v), the layout the port's attention takes;
  * int8 linears (``quantize_transformer_params``' ``{"q" [in, out] int8,
    "scale" [1, out] fp32, "bias"}``) become ``{"q" [out, in] int8, "scale"
    [out] fp32, "bias"}``: q stays int8 and the scale fp32, whatever the
    model dtype.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from s2v_torch.config import T5Config, TransformerConfig, VAEConfig
from s2v_torch.utils.device import resolve_device

_KERNEL_PERM = {2: (1, 0), 4: (3, 2, 0, 1), 5: (4, 3, 0, 1, 2)}


def _tensor(a, device, dtype) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(device=device, dtype=dtype)


def _is_int8_leaf(tree: dict) -> bool:
    q = tree.get("q")
    return q is not None and not isinstance(q, dict) and np.asarray(q).dtype == np.int8


def _convert(tree, device, dtype):
    """Recursively: ``{"kernel", "bias"?}`` -> ``{"weight", "bias"?}`` in torch
    layout, int8 ``{"q", "scale", "bias"?}`` likewise (see the module
    docstring); other leaves as they are."""
    if isinstance(tree, (list, tuple)):
        return [_convert(t, device, dtype) for t in tree]
    if not isinstance(tree, dict):
        return _tensor(tree, device, dtype)
    int8_leaf = _is_int8_leaf(tree)
    out = {}
    for key, val in tree.items():
        if int8_leaf and key == "q":
            q = np.asarray(val)
            if q.ndim != 2:
                raise ValueError(f"an int8 linear's q must be [in, out], got shape {q.shape}")
            out["q"] = torch.from_numpy(np.ascontiguousarray(q.T)).to(device)
        elif int8_leaf and key == "scale":
            out["scale"] = _tensor(np.asarray(val).reshape(-1), device, torch.float32)
        elif key == "kernel":
            kernel = np.asarray(val)
            if kernel.ndim not in _KERNEL_PERM:
                raise ValueError(f"no torch layout for a {kernel.ndim}-d kernel")
            out["weight"] = _tensor(kernel.transpose(_KERNEL_PERM[kernel.ndim]), device, dtype)
        else:
            out[key] = _convert(val, device, dtype)
    return out


def _unstack(blocks) -> list:
    """Stacked ``[L, ...]`` leaves -> a list of L per-layer trees."""
    if isinstance(blocks, (list, tuple)):
        return list(blocks)

    first = blocks
    while isinstance(first, dict):
        first = next(iter(first.values()))
    num_layers = np.asarray(first).shape[0]

    def take(t, i):
        return {k: take(v, i) for k, v in t.items()} if isinstance(t, dict) else np.asarray(t)[i]

    return [take(blocks, i) for i in range(num_layers)]


def _fuse_qkv(attn: dict) -> dict:
    if "qkv" in attn:
        return attn
    out = {k: v for k, v in attn.items() if k not in ("to_q", "to_k", "to_v")}
    parts = [attn[n] for n in ("to_q", "to_k", "to_v")]
    out["qkv"] = {"kernel": np.concatenate([np.asarray(p["kernel"]) for p in parts], axis=-1)}
    if all("bias" in p for p in parts):
        out["qkv"]["bias"] = np.concatenate([np.asarray(p["bias"]) for p in parts], axis=-1)
    return out


def transformer_from_jax(params: dict, cfg: TransformerConfig,
                         device: Optional[Union[str, torch.device]] = None) -> dict:
    """``s2v_tpu`` transformer params -> the port's ``transformer_forward`` params."""
    device = resolve_device(device)
    blocks = []
    for layer in _unstack(params["blocks"]):
        layer = dict(layer)
        layer["attn"] = _fuse_qkv(layer["attn"])
        blocks.append(_convert(layer, device, cfg.dtype))
    out = {k: _convert(v, device, cfg.dtype) for k, v in params.items() if k != "blocks"}
    out["blocks"] = blocks
    return out


def vae_from_jax(params: dict, cfg: VAEConfig, device: Optional[Union[str, torch.device]] = None) -> dict:
    """``s2v_tpu`` VAE params (``{"encoder", "decoder"}``) -> the port's, with
    channels-first conv kernels."""
    return _convert(params, resolve_device(device), cfg.dtype)


def t5_from_jax(params: dict, cfg: T5Config, device: Optional[Union[str, torch.device]] = None) -> dict:
    """``s2v_tpu`` T5 params -> the port's ``t5_encode`` params."""
    device = resolve_device(device)
    out = {k: _convert(v, device, cfg.dtype) for k, v in params.items() if k != "blocks"}
    out["blocks"] = [_convert(layer, device, cfg.dtype) for layer in _unstack(params["blocks"])]
    return out


def lora_from_jax(tree, device: Optional[Union[str, torch.device]] = None,
                  dtype: torch.dtype = torch.float32):
    """A JAX LoRA tree (the trainer's ``{target: {"a", "b"}}`` or a runtime
    ``{"blocks": ..., "top": ...}`` tree, numpy leaves) -> the same tree of
    tensors on ``device``.  Both packages keep the factors in one layout
    (``a [..., in, r]``, ``b [..., r, out]``), so nothing is transposed."""
    device = resolve_device(device)
    if isinstance(tree, dict):
        return {k: lora_from_jax(v, device, dtype) for k, v in tree.items()}
    return _tensor(tree, device, dtype)
