"""HF-layout (diffusers / transformers) state dicts -> the port's parameter
trees (counterpart of ``s2v_tpu/loaders/hf.py``).

The checkpoints already hold torch layouts, so the port's trees take most
tensors as they are: ``[out, in]`` linears and channels-first convs.  What
changes: the key names become nested dicts with one dict per layer, the
attention's ``to_q``/``to_k``/``to_v`` are fused into one ``qkv`` (rows
q | k | v), and the patch-embedding conv ``[D, C, p, p]`` becomes the
space-to-depth matmul weight ``[D, p·p·C]`` (columns ordered ph, pw, c);
CogVideoX1.5's patch embedding is a Linear ``[D, C·pₜ·p·p]`` already in the
port's (c, pₜ, ph, pw) order, taken as it is, with no bias where the
config's ``patch_bias`` is false.
The result is the tree ``loaders/jax_params.py`` builds from the JAX
package's converted params, as CPU tensors in the config's dtype; the
pipeline moves it to its device in one pass.  No arithmetic happens except
the opt-in int8 quantization, so a snapshot in the model dtype converts bit
for bit.  LoRA is merged into the state dict before conversion
(``s2v_torch/loaders/lora.py``).
"""

from __future__ import annotations

from typing import Dict

import torch

from s2v_torch.config import T5Config, TransformerConfig, VAEConfig


def _wb(sd, prefix, dtype, bias=True):
    """``{"weight", "bias"?}`` of a linear, conv or norm, cast to ``dtype``
    (None: as stored)."""
    keys = ("weight", "bias") if bias else ("weight",)
    return {k: sd[f"{prefix}.{k}"] if dtype is None else sd[f"{prefix}.{k}"].to(dtype) for k in keys}


# ---------------------------------------------------------------------------
# transformer
# ---------------------------------------------------------------------------


def quantize_host(weight: torch.Tensor, bias: torch.Tensor, dtype) -> dict:
    """Per-output-channel int8 of an ``[out, in]`` weight, with the JAX
    loader's arithmetic (``_quantize_host``, ``s2v_tpu/loaders/hf.py:51-57``):
    ``amax / 127.0`` as a true fp32 division, round half to even, clip to
    ±127, a zero scale replaced by 1.  (``ops.quant.quantize_weight_int8``
    multiplies by the reciprocal instead, as the JAX pipeline's jitted
    ``quantize_transformer_params`` does, which can differ in the last bit.)"""
    w = weight.float()
    scale = w.abs().amax(-1) / 127.0
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    q = torch.round(w / scale[:, None]).clamp(-127, 127).to(torch.int8)
    return {"q": q, "scale": scale, "bias": bias.to(dtype)}


def convert_transformer_state_dict(
    sd: Dict[str, torch.Tensor], cfg: TransformerConfig, quantize_int8: bool = False
) -> dict:
    """HF ``CogVideoXTransformer3DModel`` state dict -> the port's DiT params
    (``transformer_forward``), CPU tensors.  ``quantize_int8`` makes the
    fused qkv, ``to_out`` and both feed-forward linears int8 leaves
    (``{"q" [out, in] int8, "scale" [out] fp32, "bias"}``, see
    ``s2v_torch/ops/quant.py``), quantized on the host."""
    dt = cfg.dtype
    conv_w = sd["patch_embed.proj.weight"]
    d = conv_w.shape[0]
    blocks = []
    for i in range(cfg.num_layers):
        pre = f"transformer_blocks.{i}"
        # the four linears ops.quant.QUANTIZED_LEAVES names, in the checkpoint's dtype
        linears = {
            ("attn", "qkv"): {n: torch.cat([sd[f"{pre}.attn1.to_{x}.{n}"] for x in "qkv"]) for n in ("weight", "bias")},
            ("attn", "to_out"): _wb(sd, f"{pre}.attn1.to_out.0", None),
            ("ff", "net_0"): _wb(sd, f"{pre}.ff.net.0.proj", None),
            ("ff", "net_2"): _wb(sd, f"{pre}.ff.net.2", None),
        }
        layer = {
            "norm1": {"linear": _wb(sd, f"{pre}.norm1.linear", dt), "norm": _wb(sd, f"{pre}.norm1.norm", dt)},
            "attn": {"norm_q": _wb(sd, f"{pre}.attn1.norm_q", dt), "norm_k": _wb(sd, f"{pre}.attn1.norm_k", dt)},
            "norm2": {"linear": _wb(sd, f"{pre}.norm2.linear", dt), "norm": _wb(sd, f"{pre}.norm2.norm", dt)},
            "ff": {},
        }
        # the pre-merge modulation linears of the disentangled mode, when the
        # state dict carries them (S2VPipeline.from_pretrained adds them
        # before a LoRA merge; s2v_tpu/loaders/hf.py:135-139)
        if f"{pre}.norm1.base_linear.weight" in sd:
            for n in ("norm1", "norm2"):
                layer[n]["base_linear"] = _wb(sd, f"{pre}.{n}.base_linear", dt)
        for (group, name), wb in linears.items():
            # int8 from the checkpoint's own values, as the JAX loader
            # quantizes the fp32 kernel before any cast to the model dtype
            layer[group][name] = (quantize_host(wb["weight"], wb["bias"], dt) if quantize_int8
                                  else {k: v.to(dt) for k, v in wb.items()})
        blocks.append(layer)

    if cfg.patch_size_t is None:
        proj = {"weight": conv_w.permute(0, 2, 3, 1).reshape(d, -1).to(dt)}
    else:  # CogVideoX1.5: a Linear [D, C·pₜ·p·p], features (c, pₜ, ph, pw) as the port's patchify takes them
        proj = {"weight": conv_w.to(dt)}
    if "patch_embed.proj.bias" in sd:
        proj["bias"] = sd["patch_embed.proj.bias"].to(dt)
    elif cfg.patch_bias:
        raise KeyError("patch_embed.proj.bias: the config's patch_bias is true")
    return {
        "patch_embed": {
            "proj": proj,
            "text_proj": _wb(sd, "patch_embed.text_proj", dt),
        },
        "time_embedding": {
            "linear_1": _wb(sd, "time_embedding.linear_1", dt),
            "linear_2": _wb(sd, "time_embedding.linear_2", dt),
        },
        "blocks": blocks,
        "norm_final": _wb(sd, "norm_final", dt),
        "norm_out": {"linear": _wb(sd, "norm_out.linear", dt), "norm": _wb(sd, "norm_out.norm", dt)},
        "proj_out": _wb(sd, "proj_out", dt),
    }


# ---------------------------------------------------------------------------
# VAE
# ---------------------------------------------------------------------------


def _spatial_norm(sd, prefix, dtype):
    return {
        "norm": _wb(sd, prefix + ".norm_layer", dtype),
        "conv_y": _wb(sd, prefix + ".conv_y.conv", dtype),
        "conv_b": _wb(sd, prefix + ".conv_b.conv", dtype),
    }


def _resnet(sd, prefix, dtype, spatial: bool):
    p = {
        "conv1": _wb(sd, prefix + ".conv1.conv", dtype),
        "conv2": _wb(sd, prefix + ".conv2.conv", dtype),
    }
    norm = _spatial_norm if spatial else _wb
    p["norm1"] = norm(sd, prefix + ".norm1", dtype)
    p["norm2"] = norm(sd, prefix + ".norm2", dtype)
    if prefix + ".conv_shortcut.weight" in sd:
        p["conv_shortcut"] = _wb(sd, prefix + ".conv_shortcut", dtype)
    return p


def convert_vae_state_dict(sd: Dict[str, torch.Tensor], cfg: VAEConfig) -> dict:
    """HF ``AutoencoderKLCogVideoX`` state dict -> the port's VAE params
    (channels-first conv weights, as stored), CPU tensors."""
    dt = cfg.dtype
    n_blocks = len(cfg.block_out_channels)
    enc = {
        "conv_in": _wb(sd, "encoder.conv_in.conv", dt),
        "down_blocks": [],
        "mid_block": {"resnets": [_resnet(sd, f"encoder.mid_block.resnets.{j}", dt, False) for j in range(2)]},
        "norm_out": _wb(sd, "encoder.norm_out", dt),
        "conv_out": _wb(sd, "encoder.conv_out.conv", dt),
    }
    for i in range(n_blocks):
        block = {"resnets": [_resnet(sd, f"encoder.down_blocks.{i}.resnets.{j}", dt, False)
                             for j in range(cfg.layers_per_block)]}
        if f"encoder.down_blocks.{i}.downsamplers.0.conv.weight" in sd:
            block["downsampler"] = {"conv": _wb(sd, f"encoder.down_blocks.{i}.downsamplers.0.conv", dt)}
        enc["down_blocks"].append(block)

    dec = {
        "conv_in": _wb(sd, "decoder.conv_in.conv", dt),
        "mid_block": {"resnets": [_resnet(sd, f"decoder.mid_block.resnets.{j}", dt, True) for j in range(2)]},
        "up_blocks": [],
        "norm_out": _spatial_norm(sd, "decoder.norm_out", dt),
        "conv_out": _wb(sd, "decoder.conv_out.conv", dt),
    }
    for i in range(n_blocks):
        block = {"resnets": [_resnet(sd, f"decoder.up_blocks.{i}.resnets.{j}", dt, True)
                             for j in range(cfg.layers_per_block + 1)]}
        if f"decoder.up_blocks.{i}.upsamplers.0.conv.weight" in sd:
            block["upsampler"] = {"conv": _wb(sd, f"decoder.up_blocks.{i}.upsamplers.0.conv", dt)}
        dec["up_blocks"].append(block)
    return {"encoder": enc, "decoder": dec}


# ---------------------------------------------------------------------------
# T5
# ---------------------------------------------------------------------------


def convert_t5_state_dict(sd: Dict[str, torch.Tensor], cfg: T5Config) -> dict:
    """HF ``T5EncoderModel`` state dict -> the port's ``t5_encode`` params,
    CPU tensors.  The embedding is ``shared.weight`` or its tied copy
    ``encoder.embed_tokens.weight``."""
    dt = cfg.dtype
    blocks = []
    for i in range(cfg.num_layers):
        pre = f"encoder.block.{i}"
        blocks.append({
            "ln1": {"weight": sd[f"{pre}.layer.0.layer_norm.weight"].to(dt)},
            "attn": {n: _wb(sd, f"{pre}.layer.0.SelfAttention.{n}", dt, bias=False) for n in ("q", "k", "v", "o")},
            "ln2": {"weight": sd[f"{pre}.layer.1.layer_norm.weight"].to(dt)},
            "mlp": {n: _wb(sd, f"{pre}.layer.1.DenseReluDense.{n}", dt, bias=False)
                    for n in ("wi_0", "wi_1", "wo")},
        })
    emb_key = "shared.weight" if "shared.weight" in sd else "encoder.embed_tokens.weight"
    return {
        "embedding": sd[emb_key].to(dt),
        "relative_attention_bias": sd["encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight"].to(dt),
        "blocks": blocks,
        "final_ln": {"weight": sd["encoder.final_layer_norm.weight"].to(dt)},
    }
