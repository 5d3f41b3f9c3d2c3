"""Subject LoRA checkpoints: merge at load, or a runtime factor tree
(counterpart of ``s2v_tpu/loaders/lora.py``).

The reference injects rank-128, alpha-64 adapters (scale 0.5) into 9
module families: the attention projections, the conv patch embed,
``text_proj``, both adaLN modulation linears and ``ff.net.2``.  **Merge**
folds ``W += (alpha/r) · B @ A`` into the torch-layout base state dict once,
on the host in fp32 (:func:`merge_lora_into_state_dict`); the **runtime**
tree keeps the factors apart for the DiT to apply per layer
(:func:`runtime_lora_tree`).  Key handling follows the diffusers/PEFT chain:
the ``transformer.`` prefix is stripped and ``.lora.down``/``.lora.up`` (or
``.lora_A.default``/``.lora_B.default``) become ``lora_A``/``lora_B``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from s2v_torch.loaders.safetensors_io import best_guess_lora_file, load_safetensors


def normalize_lora_keys(state_dict: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """diffusers-format -> canonical ``<module>.lora_A/B`` pairs."""
    out = {}
    for k, v in state_dict.items():
        if k.startswith("transformer."):
            k = k[len("transformer."):]
        k = k.replace(".lora.down.weight", ".lora_A.weight")
        k = k.replace(".lora.up.weight", ".lora_B.weight")
        k = k.replace(".lora_A.default.weight", ".lora_A.weight")
        k = k.replace(".lora_B.default.weight", ".lora_B.weight")
        out[k] = v
    return out


def lora_pairs(state_dict: Dict[str, torch.Tensor]):
    """Yield (module_name, A, B) for every lora pair in a normalized dict."""
    for k in sorted(state_dict):
        if k.endswith(".lora_A.weight"):
            module = k[: -len(".lora_A.weight")]
            b_key = module + ".lora_B.weight"
            if b_key not in state_dict:
                raise KeyError(f"unpaired LoRA key: {k}")
            yield module, state_dict[k], state_dict[b_key]


def merge_lora_into_state_dict(
    base_sd: Dict[str, torch.Tensor],
    lora_sd: Dict[str, torch.Tensor],
    alpha: float = 64.0,
    rank: Optional[int] = None,
) -> Tuple[Dict[str, torch.Tensor], list]:
    """Merge LoRA deltas into a torch-layout base state dict, in fp32, each
    merged weight cast back to its stored dtype.  Linear pairs are
    ``A [r, in]``, ``B [out, r]``; the k=2 conv patch embed's pair is
    ``A [r, C, kh, kw]``, ``B [out, r, 1, 1]`` and flattens to a product
    over ``C·kh·kw``.  The scale is ``alpha / rank``, the rank taken from A
    unless given.  ``base_sd`` is not modified.  Returns ``(merged_sd,
    merged_module_names)``."""
    merged = dict(base_sd)
    touched = []
    for module, a, b in lora_pairs(normalize_lora_keys(lora_sd)):
        w_key = module + ".weight"
        if w_key not in merged:
            raise KeyError(f"LoRA target {w_key} not present in base state dict")
        w = merged[w_key].float()
        a, b = a.float(), b.float()
        scale = alpha / (rank or a.shape[0])
        if a.ndim == 2 and b.ndim == 2:
            delta = scale * (b @ a)  # [out, in]
        elif a.ndim == 4 and b.ndim == 4:
            r_, cin, kh, kw = a.shape
            delta = (scale * (b.reshape(b.shape[0], r_) @ a.reshape(r_, cin * kh * kw))).reshape(b.shape[0], cin, kh, kw)
        else:
            raise ValueError(f"unsupported LoRA shapes for {module}: {tuple(a.shape)} / {tuple(b.shape)}")
        if delta.shape != w.shape:
            raise ValueError(f"merge shape mismatch for {module}: {tuple(delta.shape)} vs {tuple(w.shape)}")
        merged[w_key] = (w + delta).to(base_sd[w_key].dtype)
        touched.append(module)
    return merged, touched


def load_and_merge_lora(
    base_sd: Dict[str, torch.Tensor], ckpt_dir: str, alpha: float = 64.0, rank: Optional[int] = None
):
    """Resolve the checkpoint file, read it, merge it (:func:`merge_lora_into_state_dict`)."""
    lora_sd = load_safetensors(best_guess_lora_file(ckpt_dir))
    return merge_lora_into_state_dict(base_sd, lora_sd, alpha=alpha, rank=rank)


# ---------------------------------------------------------------------------
# runtime (unmerged) factor trees
# ---------------------------------------------------------------------------

# reference per-block module suffix -> runtime target name
_BLOCK_SUFFIXES = {
    "attn1.to_q": "to_q",
    "attn1.to_k": "to_k",
    "attn1.to_v": "to_v",
    "attn1.to_out.0": "to_out",
    "norm1.linear": "norm1.linear",
    "norm2.linear": "norm2.linear",
    "ff.net.2": "ff.net.2",
}


def runtime_lora_tree(
    lora_sd: Dict[str, torch.Tensor],
    num_layers: int,
    alpha: float = 64.0,
    rank: Optional[int] = None,
) -> dict:
    """Reference-format LoRA state dict -> the runtime factor tree the port's
    DiT applies per layer (``params[RUNTIME_LORA_KEY]``,
    ``s2v_torch/models/transformer.py``), fp32 CPU tensors::

        {"blocks": {name: {"a": [L, in, r], "b": [L, r, out]}},
         "top":    {name: {"a": [in, r],    "b": [r, out]}}}

    the ``alpha/r`` scale folded into ``a``.  Block names: to_q | to_k |
    to_v | to_out | norm1.linear | norm2.linear | ff.net.2; top names:
    patch_proj (the conv pair flattened to the patch-embedding matmul's
    (kh, kw, c) rows) | text_proj.  Layers without an adapter for a family
    get zero factors."""
    per_block: Dict[str, dict] = {}
    top: Dict[str, dict] = {}
    for module, a, b in lora_pairs(normalize_lora_keys(lora_sd)):
        a, b = a.float(), b.float()
        scale = alpha / (rank or a.shape[0])
        if module == "patch_embed.proj":
            r_, c, kh, kw = a.shape
            top["patch_proj"] = {"a": a.permute(2, 3, 1, 0).reshape(kh * kw * c, r_) * scale,
                                 "b": b.reshape(b.shape[0], r_).T.contiguous()}
            continue
        if module == "patch_embed.text_proj":
            top["text_proj"] = {"a": a.T * scale, "b": b.T.contiguous()}
            continue
        if module.startswith("transformer_blocks."):
            _, layer, suffix = module.split(".", 2)
            name = _BLOCK_SUFFIXES.get(suffix)
            if name is None:
                raise KeyError(f"unsupported runtime LoRA target: {module}")
            per_block.setdefault(name, {})[int(layer)] = (a.T * scale, b.T)
            continue
        raise KeyError(f"unsupported runtime LoRA target: {module}")

    blocks = {}
    for name, layers in per_block.items():
        a0, b0 = next(iter(layers.values()))
        a_stack = torch.zeros((num_layers,) + tuple(a0.shape))
        b_stack = torch.zeros((num_layers,) + tuple(b0.shape))
        for i, (a_i, b_i) in layers.items():
            if a_i.shape != a0.shape or b_i.shape != b0.shape:
                raise ValueError(
                    f"runtime LoRA needs a uniform rank per family; {name} has "
                    f"{tuple(a0.shape)}/{tuple(b0.shape)} and {tuple(a_i.shape)}/{tuple(b_i.shape)}"
                )
            a_stack[i], b_stack[i] = a_i, b_i
        blocks[name] = {"a": a_stack, "b": b_stack}
    tree = {}
    if blocks:
        tree["blocks"] = blocks
    if top:
        tree["top"] = top
    return tree


def load_runtime_lora(ckpt_dir: str, num_layers: int, alpha: float = 64.0, rank: Optional[int] = None) -> dict:
    """Resolve + read a reference checkpoint dir into a runtime factor tree."""
    return runtime_lora_tree(load_safetensors(best_guess_lora_file(ckpt_dir)), num_layers, alpha=alpha, rank=rank)
