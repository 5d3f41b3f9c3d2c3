"""The port's parameter trees back to the HF snapshot layout (counterpart of
``s2v_tpu/loaders/export_hf.py``): the inverses of ``loaders/hf.py``.

The fused ``qkv`` splits back into ``to_q``/``to_k``/``to_v``, the
patch-embedding matmul weight back into its ``[D, C, p, p]`` conv, and the
nested trees back into diffusers (transformer, VAE) and transformers (T5)
keys.  ``save_pipeline_snapshot`` writes a diffusers-layout snapshot that
the port's and the JAX package's ``from_pretrained`` both load.  The state
dicts hold views of the parameters, on their device and in their dtype; the
writer casts and moves one tensor at a time to the host.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import shutil
from typing import Optional

import torch

from s2v_torch.config import T5Config, TransformerConfig, VAEConfig
from s2v_torch.loaders.safetensors_io import save_safetensors

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}


def _wb(sd, prefix, p, bias=True):
    sd[prefix + ".weight"] = p["weight"]
    if bias and "bias" in p:
        sd[prefix + ".bias"] = p["bias"]


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _check_not_quantized(params, what: str):
    if any(getattr(leaf, "dtype", None) == torch.int8 for leaf in _leaves(params)):
        raise ValueError(
            f"cannot export an int8-quantized {what} tree to the HF "
            "layout (the reference stores bf16/fp32 weights); reload "
            "without quantize_int8 to export"
        )


# ---------------------------------------------------------------------------
# transformer (inverse of loaders.hf.convert_transformer_state_dict)
# ---------------------------------------------------------------------------


def transformer_state_dict(params, cfg: TransformerConfig) -> dict:
    _check_not_quantized(params, "transformer")
    sd: dict = {}
    p, d = cfg.patch_size, cfg.inner_dim
    proj = params["patch_embed"]["proj"]
    sd["patch_embed.proj.weight"] = proj["weight"].reshape(d, p, p, cfg.in_channels).permute(0, 3, 1, 2)
    sd["patch_embed.proj.bias"] = proj["bias"]
    _wb(sd, "patch_embed.text_proj", params["patch_embed"]["text_proj"])
    _wb(sd, "time_embedding.linear_1", params["time_embedding"]["linear_1"])
    _wb(sd, "time_embedding.linear_2", params["time_embedding"]["linear_2"])
    for i, b in enumerate(params["blocks"]):
        pre = f"transformer_blocks.{i}"
        qkv = b["attn"]["qkv"]
        for j, n in enumerate("qkv"):
            sd[f"{pre}.attn1.to_{n}.weight"] = qkv["weight"][j * d:(j + 1) * d]
            sd[f"{pre}.attn1.to_{n}.bias"] = qkv["bias"][j * d:(j + 1) * d]
        _wb(sd, f"{pre}.attn1.norm_q", b["attn"]["norm_q"])
        _wb(sd, f"{pre}.attn1.norm_k", b["attn"]["norm_k"])
        _wb(sd, f"{pre}.attn1.to_out.0", b["attn"]["to_out"])
        _wb(sd, f"{pre}.norm1.linear", b["norm1"]["linear"])
        _wb(sd, f"{pre}.norm1.norm", b["norm1"]["norm"])
        _wb(sd, f"{pre}.norm2.linear", b["norm2"]["linear"])
        _wb(sd, f"{pre}.norm2.norm", b["norm2"]["norm"])
        _wb(sd, f"{pre}.ff.net.0.proj", b["ff"]["net_0"])
        _wb(sd, f"{pre}.ff.net.2", b["ff"]["net_2"])
    _wb(sd, "norm_final", params["norm_final"])
    _wb(sd, "norm_out.linear", params["norm_out"]["linear"])
    _wb(sd, "norm_out.norm", params["norm_out"]["norm"])
    _wb(sd, "proj_out", params["proj_out"])
    return sd


# ---------------------------------------------------------------------------
# VAE (inverse of loaders.hf.convert_vae_state_dict)
# ---------------------------------------------------------------------------


def _norm(sd, prefix, p):
    if "conv_y" in p:  # SpatialNorm3D
        _wb(sd, prefix + ".norm_layer", p["norm"])
        _wb(sd, prefix + ".conv_y.conv", p["conv_y"])
        _wb(sd, prefix + ".conv_b.conv", p["conv_b"])
    else:
        _wb(sd, prefix, p)


def _resnet(sd, prefix, p):
    _wb(sd, prefix + ".conv1.conv", p["conv1"])
    _wb(sd, prefix + ".conv2.conv", p["conv2"])
    _norm(sd, prefix + ".norm1", p["norm1"])
    _norm(sd, prefix + ".norm2", p["norm2"])
    if "conv_shortcut" in p:
        _wb(sd, prefix + ".conv_shortcut", p["conv_shortcut"])


def vae_state_dict(params, cfg: VAEConfig) -> dict:
    _check_not_quantized(params, "vae")
    sd: dict = {}
    enc, dec = params["encoder"], params["decoder"]
    _wb(sd, "encoder.conv_in.conv", enc["conv_in"])
    for i, block in enumerate(enc["down_blocks"]):
        for j, r in enumerate(block["resnets"]):
            _resnet(sd, f"encoder.down_blocks.{i}.resnets.{j}", r)
        if "downsampler" in block:
            _wb(sd, f"encoder.down_blocks.{i}.downsamplers.0.conv", block["downsampler"]["conv"])
    for j, r in enumerate(enc["mid_block"]["resnets"]):
        _resnet(sd, f"encoder.mid_block.resnets.{j}", r)
    _wb(sd, "encoder.norm_out", enc["norm_out"])
    _wb(sd, "encoder.conv_out.conv", enc["conv_out"])

    _wb(sd, "decoder.conv_in.conv", dec["conv_in"])
    for j, r in enumerate(dec["mid_block"]["resnets"]):
        _resnet(sd, f"decoder.mid_block.resnets.{j}", r)
    for i, block in enumerate(dec["up_blocks"]):
        for j, r in enumerate(block["resnets"]):
            _resnet(sd, f"decoder.up_blocks.{i}.resnets.{j}", r)
        if "upsampler" in block:
            _wb(sd, f"decoder.up_blocks.{i}.upsamplers.0.conv", block["upsampler"]["conv"])
    _norm(sd, "decoder.norm_out", dec["norm_out"])
    _wb(sd, "decoder.conv_out.conv", dec["conv_out"])
    return sd


# ---------------------------------------------------------------------------
# T5 encoder (inverse of loaders.hf.convert_t5_state_dict)
# ---------------------------------------------------------------------------


def t5_state_dict(params, cfg: T5Config) -> dict:
    _check_not_quantized(params, "text encoder")
    sd = {
        "shared.weight": (params["embedding"]),
        "encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight": (params["relative_attention_bias"]),
    }
    for i, b in enumerate(params["blocks"]):
        pre = f"encoder.block.{i}"
        sd[f"{pre}.layer.0.layer_norm.weight"] = b["ln1"]["weight"]
        for n in ("q", "k", "v", "o"):
            _wb(sd, f"{pre}.layer.0.SelfAttention.{n}", b["attn"][n], bias=False)
        sd[f"{pre}.layer.1.layer_norm.weight"] = b["ln2"]["weight"]
        for n in ("wi_0", "wi_1", "wo"):
            _wb(sd, f"{pre}.layer.1.DenseReluDense.{n}", b["mlp"][n], bias=False)
    sd["encoder.final_layer_norm.weight"] = params["final_ln"]["weight"]
    return sd


# ---------------------------------------------------------------------------
# snapshot writer
# ---------------------------------------------------------------------------

# written into exported configs so diffusers' ConfigMixin and
# DiffusionPipeline.from_pretrained accept the snapshot
_DIFFUSERS_VERSION = "0.32.0.dev0"


def config_json(cfg, skip=("dtype",), class_name: Optional[str] = None) -> dict:
    """A config dataclass as a HF ``config.json`` dict (tuples as lists)."""
    out = {}
    if class_name is not None:
        out["_class_name"] = class_name
        out["_diffusers_version"] = _DIFFUSERS_VERSION
    for f in dataclasses.fields(cfg):
        if f.name in skip:
            continue
        v = getattr(cfg, f.name)
        out[f.name] = list(v) if isinstance(v, tuple) else v
    return out


def save_pipeline_snapshot(pipe, out_dir: str, dtype: Optional[str] = None) -> str:
    """Write the pipeline's current weights as a diffusers-layout snapshot::

        <out>/model_index.json
        <out>/transformer/{config.json, diffusion_pytorch_model.safetensors}
        <out>/vae/{config.json, diffusion_pytorch_model.safetensors}
        <out>/text_encoder/{config.json, model.safetensors}   (if loaded)
        <out>/tokenizer/...                                   (if available)
        <out>/scheduler/scheduler_config.json

    A merged LoRA is in the transformer's weights.  ``dtype``: the on-disk
    dtype (``"bfloat16"``, ``"float16"``, ``"float32"``); None writes fp32.
    One tensor at a time is cast and copied to the host."""
    cast = _DTYPES[dtype or "float32"]
    subs = [
        ("transformer", pipe.transformer_cfg, "CogVideoXTransformer3DModel", "diffusion_pytorch_model.safetensors",
         transformer_state_dict(pipe.transformer_params, pipe.transformer_cfg)),
        ("vae", pipe.vae_cfg, "AutoencoderKLCogVideoX", "diffusion_pytorch_model.safetensors",
         vae_state_dict(pipe.vae_params, pipe.vae_cfg)),
    ]
    if pipe.t5_params is not None:
        subs.append(("text_encoder", pipe.t5_cfg, None, "model.safetensors",
                     t5_state_dict(pipe.t5_params, pipe.t5_cfg)))
    for sub, cfg, class_name, weights_name, sd in subs:
        d = os.path.join(out_dir, sub)
        os.makedirs(d, exist_ok=True)
        cj = config_json(cfg, class_name=class_name)
        if sub == "text_encoder":
            # transformers (not diffusers) reads this one; the port's T5 is
            # the v1.1 gated-GELU encoder, which transformers' T5Config does
            # not default to
            cj.update(model_type="t5", architectures=["T5EncoderModel"], feed_forward_proj="gated-gelu")
        with open(os.path.join(d, "config.json"), "w") as f:
            json.dump(cj, f, indent=1)
        save_safetensors(sd, os.path.join(d, weights_name), dtype=cast)

    os.makedirs(os.path.join(out_dir, "scheduler"), exist_ok=True)
    with open(os.path.join(out_dir, "scheduler", "scheduler_config.json"), "w") as f:
        json.dump(config_json(pipe.scheduler_cfg, skip=(), class_name="CogVideoXDDIMScheduler"), f, indent=1)

    had_tokenizer = _save_tokenizer(pipe, out_dir)
    # a serialized `tokenizers` backend loads via the Fast class; a raw
    # spiece.model needs the slow T5Tokenizer
    tok_class = ("T5TokenizerFast" if os.path.exists(os.path.join(out_dir, "tokenizer", "tokenizer.json"))
                 else "T5Tokenizer")
    index = {
        "_class_name": "CogVideoXPipeline",
        "_diffusers_version": _DIFFUSERS_VERSION,
        "scheduler": ["diffusers", "CogVideoXDDIMScheduler"],
        "transformer": ["diffusers", "CogVideoXTransformer3DModel"],
        "vae": ["diffusers", "AutoencoderKLCogVideoX"],
        "text_encoder": ["transformers", "T5EncoderModel"] if pipe.t5_params is not None else [None, None],
        "tokenizer": ["transformers", tok_class] if had_tokenizer else [None, None],
    }
    with open(os.path.join(out_dir, "model_index.json"), "w") as f:
        json.dump(index, f, indent=1)
    return out_dir


def _save_tokenizer(pipe, out_dir: str) -> bool:
    """Copy the tokenizer files from the source snapshot when known, else
    serialize a ``tokenizers`` backend; otherwise (a native sentencepiece
    tokenizer without a source dir) skip with a warning.  Returns True when
    ``tokenizer/`` was written."""
    tok_dir = os.path.join(out_dir, "tokenizer")
    src = getattr(pipe, "model_dir", None)
    if src:
        src_tok = os.path.join(src, "tokenizer")
        if os.path.isdir(src_tok) and os.path.abspath(src_tok) != os.path.abspath(tok_dir):
            shutil.copytree(src_tok, tok_dir, dirs_exist_ok=True)
            return True
    inner = getattr(getattr(pipe, "tokenizer", None), "_tok", None)
    if inner is not None and hasattr(inner, "save"):
        os.makedirs(tok_dir, exist_ok=True)
        inner.save(os.path.join(tok_dir, "tokenizer.json"))
        return True
    logging.getLogger("s2v_torch").warning(
        "save_pretrained: no serializable tokenizer (source dir unknown); snapshot written without tokenizer/")
    return False
