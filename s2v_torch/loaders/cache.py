"""Converted-parameter checkpoint cache (counterpart of
``s2v_tpu/loaders/cache.py``).

Any parameter tree of the port (converted, LoRA-merged, int8, or trained
factors) is written as one flat safetensors file and read back without the
HF-layout conversion: a fast cold start, and a save/restore surface for
trained parameters.  Keys join the tree's path with ``::``; list indices
are path segments of digits.
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import torch

from s2v_torch.loaders.safetensors_io import load_safetensors, save_safetensors
from s2v_torch.utils.device import resolve_device

_SEP = "::"


def flatten_pytree(params) -> Dict[str, torch.Tensor]:
    """Nested dict/list tree -> flat ``{"a::b::0::c": tensor}`` mapping."""
    flat = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(prefix + [str(k)], node[k])
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(prefix + [str(i)], v)
        else:
            flat[_SEP.join(prefix)] = node

    walk([], params)
    return flat


def unflatten_pytree(flat: Dict[str, torch.Tensor]):
    """Inverse of :func:`flatten_pytree`; integer path segments become
    list indices."""
    root: dict = {}
    for key, value in flat.items():
        parts = key.split(_SEP)
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value

    def listify(node):
        if not isinstance(node, dict):
            return node
        keys = list(node.keys())
        if keys and all(k.isdigit() for k in keys):
            return [listify(node[str(i)]) for i in range(len(keys))]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)


def save_params(params, path: str, dtype: Optional[torch.dtype] = None) -> None:
    """Write a tree (tensors on any device) to one safetensors file, every
    leaf cast to ``dtype`` if given."""
    save_safetensors(flatten_pytree(params), path, dtype=dtype)


def load_params(path: str, dtype: Optional[torch.dtype] = None,
                device: Optional[Union[str, torch.device]] = None):
    """Read a tree written by :func:`save_params` onto ``device`` (CUDA
    unless the caller asks for the CPU), every leaf cast to ``dtype`` if
    given."""
    device = resolve_device(device)
    flat = {k: v.to(device=device, dtype=dtype or v.dtype) for k, v in load_safetensors(path).items()}
    return unflatten_pytree(flat)
