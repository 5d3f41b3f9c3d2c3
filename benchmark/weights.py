"""Random weights from the seed, as diffusers- and transformers-layout state
dicts under the published key names, made on the device in the model dtype.

Each model's tensors are views into one buffer filled by one ``randn``
call, then scaled in place: kernels by ``1/sqrt(fan_in)``, biases by 0.02,
norm scales to ``1 + 0.1·n``.  The attention's separate ``to_q``/``to_k``/
``to_v`` leaves sit in a second buffer, which is freed once the port has
fused them, so the process holds what a loaded snapshot would.  The same
seed gives the same tensors, so the reference can make them again.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

Shapes = List[Tuple[str, Tuple[int, ...]]]


def derive_seed(seed: int, *stream) -> int:
    """A 63-bit seed for one named stream of a run's seed."""
    words = [int(seed) & 0xFFFFFFFF, int(seed) >> 32]
    for s in stream:
        words.extend(s.encode() if isinstance(s, str) else [int(s) & 0xFFFFFFFF])
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0] >> np.uint64(1))


def generator(device, seed: int, *stream) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(derive_seed(seed, *stream))


def dit_shapes(t: dict) -> Shapes:
    """``CogVideoXTransformer3DModel`` keys and shapes of a transformer config."""
    d = t["num_attention_heads"] * t["attention_head_dim"]
    te, p, hd = t["time_embed_dim"], t["patch_size"], t["attention_head_dim"]
    ff = 4 * d
    out: Shapes = [
        ("patch_embed.proj.weight", (d, t["in_channels"], p, p)), ("patch_embed.proj.bias", (d,)),
        ("patch_embed.text_proj.weight", (d, t["text_embed_dim"])), ("patch_embed.text_proj.bias", (d,)),
        ("time_embedding.linear_1.weight", (te, d)), ("time_embedding.linear_1.bias", (te,)),
        ("time_embedding.linear_2.weight", (te, te)), ("time_embedding.linear_2.bias", (te,)),
    ]
    for i in range(t["num_layers"]):
        b = f"transformer_blocks.{i}"
        for n in ("norm1", "norm2"):
            out += [(f"{b}.{n}.linear.weight", (6 * d, te)), (f"{b}.{n}.linear.bias", (6 * d,)),
                    (f"{b}.{n}.norm.weight", (d,)), (f"{b}.{n}.norm.bias", (d,))]
        for n in ("norm_q", "norm_k"):
            out += [(f"{b}.attn1.{n}.weight", (hd,)), (f"{b}.attn1.{n}.bias", (hd,))]
        for n in ("to_q", "to_k", "to_v"):
            out += [(f"{b}.attn1.{n}.weight", (d, d)), (f"{b}.attn1.{n}.bias", (d,))]
        out += [(f"{b}.attn1.to_out.0.weight", (d, d)), (f"{b}.attn1.to_out.0.bias", (d,)),
                (f"{b}.ff.net.0.proj.weight", (ff, d)), (f"{b}.ff.net.0.proj.bias", (ff,)),
                (f"{b}.ff.net.2.weight", (d, ff)), (f"{b}.ff.net.2.bias", (d,))]
    out += [("norm_final.weight", (d,)), ("norm_final.bias", (d,)),
            ("norm_out.linear.weight", (2 * d, te)), ("norm_out.linear.bias", (2 * d,)),
            ("norm_out.norm.weight", (d,)), ("norm_out.norm.bias", (d,)),
            ("proj_out.weight", (p * p * t["out_channels"], d)), ("proj_out.bias", (p * p * t["out_channels"],))]
    return out


def vae_shapes(v: dict) -> Shapes:
    """``AutoencoderKLCogVideoX`` keys and shapes (no quant convs)."""
    zc, chans = v["latent_channels"], list(v["block_out_channels"])
    out: Shapes = []

    def conv(name, cout, cin, *k):
        out.extend([(f"{name}.weight", (cout, cin, *k)), (f"{name}.bias", (cout,))])

    def gn(name, c):
        out.extend([(f"{name}.weight", (c,)), (f"{name}.bias", (c,))])

    def resnet(name, cin, cout, spatial):
        for n, c in (("norm1", cin), ("norm2", cout)):
            if spatial:
                gn(f"{name}.{n}.norm_layer", c)
                conv(f"{name}.{n}.conv_y.conv", c, zc, 1, 1, 1)
                conv(f"{name}.{n}.conv_b.conv", c, zc, 1, 1, 1)
            else:
                gn(f"{name}.{n}", c)
        conv(f"{name}.conv1.conv", cout, cin, 3, 3, 3)
        conv(f"{name}.conv2.conv", cout, cout, 3, 3, 3)
        if cin != cout:
            conv(f"{name}.conv_shortcut", cout, cin, 1, 1, 1)

    conv("encoder.conv_in.conv", chans[0], v["in_channels"], 3, 3, 3)
    c = chans[0]
    for i, oc in enumerate(chans):
        for j in range(v["layers_per_block"]):
            resnet(f"encoder.down_blocks.{i}.resnets.{j}", c if j == 0 else oc, oc, False)
        c = oc
        if i < len(chans) - 1:
            conv(f"encoder.down_blocks.{i}.downsamplers.0.conv", c, c, 3, 3)
    for j in range(2):
        resnet(f"encoder.mid_block.resnets.{j}", c, c, False)
    gn("encoder.norm_out", c)
    conv("encoder.conv_out.conv", 2 * zc, c, 3, 3, 3)

    rev = list(reversed(chans))
    conv("decoder.conv_in.conv", rev[0], zc, 3, 3, 3)
    for j in range(2):
        resnet(f"decoder.mid_block.resnets.{j}", rev[0], rev[0], True)
    c = rev[0]
    for i, oc in enumerate(rev):
        for j in range(v["layers_per_block"] + 1):
            resnet(f"decoder.up_blocks.{i}.resnets.{j}", c if j == 0 else oc, oc, True)
        c = oc
        if i < len(rev) - 1:
            conv(f"decoder.up_blocks.{i}.upsamplers.0.conv", c, c, 3, 3)
    gn("decoder.norm_out.norm_layer", c)
    conv("decoder.norm_out.conv_y.conv", c, zc, 1, 1, 1)
    conv("decoder.norm_out.conv_b.conv", c, zc, 1, 1, 1)
    conv("decoder.conv_out.conv", v["out_channels"], c, 3, 3, 3)
    return out


def t5_shapes(c: dict) -> Shapes:
    """``T5EncoderModel`` keys and shapes (v1.1: gated-GELU, no biases)."""
    d, inner, dff = c["d_model"], c["num_heads"] * c["d_kv"], c["d_ff"]
    out: Shapes = [("shared.weight", (c["vocab_size"], d)),
                   ("encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight",
                    (c["relative_attention_num_buckets"], c["num_heads"]))]
    for i in range(c["num_layers"]):
        b = f"encoder.block.{i}.layer"
        out += [(f"{b}.0.layer_norm.weight", (d,))]
        out += [(f"{b}.0.SelfAttention.{n}.weight", (inner, d)) for n in "qkv"]
        out += [(f"{b}.0.SelfAttention.o.weight", (d, inner)), (f"{b}.1.layer_norm.weight", (d,)),
                (f"{b}.1.DenseReluDense.wi_0.weight", (dff, d)), (f"{b}.1.DenseReluDense.wi_1.weight", (dff, d)),
                (f"{b}.1.DenseReluDense.wo.weight", (d, dff))]
    out += [("encoder.final_layer_norm.weight", (d,))]
    return out


def _init_(name: str, view: torch.Tensor) -> None:
    """Scale one standard-normal view in place to its leaf's init."""
    if name == "shared.weight":
        return
    if name.endswith("relative_attention_bias.weight"):
        view.mul_(0.1)
    elif name.endswith(".bias"):
        view.mul_(0.02)
    elif view.dim() == 1:  # the only 1-D weights of these models are norm scales
        view.mul_(0.1).add_(1.0)
    else:
        view.mul_(1.0 / math.sqrt(math.prod(view.shape[1:])))


def make_state_dict(shapes: Shapes, seed: int, stream: str, device, dtype,
                    apart=lambda name: False) -> Tuple[Dict[str, torch.Tensor], List[torch.Tensor]]:
    """The state dict of ``shapes`` drawn from (seed, stream): a buffer for
    the leaves ``apart`` selects and one for the rest, each one ``randn``.
    Returns (state dict, [buffers])."""
    groups = ([s for s in shapes if not apart(s[0])], [s for s in shapes if apart(s[0])])
    sd: Dict[str, torch.Tensor] = {}
    buffers = []
    for g, group in enumerate(groups):
        if not group:
            continue
        total = sum(math.prod(shape) for _, shape in group)
        buf = torch.randn(total, generator=generator(device, seed, stream, g), device=device, dtype=dtype)
        off = 0
        with torch.no_grad():
            for name, shape in group:
                n = math.prod(shape)
                view = buf[off:off + n].view(shape)
                _init_(name, view)
                sd[name] = view
                off += n
        buffers.append(buf)
    return sd, buffers


def _qkv(name: str) -> bool:
    return ".attn1.to_q." in name or ".attn1.to_k." in name or ".attn1.to_v." in name


def dit_state_dict(cfg: dict, seed: int, device, dtype):
    return make_state_dict(dit_shapes(cfg["transformer"]), seed, "transformer", device, dtype, apart=_qkv)


def vae_state_dict(cfg: dict, seed: int, device, dtype):
    return make_state_dict(vae_shapes(cfg["vae"]), seed, "vae", device, dtype)


def t5_state_dict(cfg: dict, seed: int, device, dtype):
    return make_state_dict(t5_shapes(cfg["text_encoder"]), seed, "text_encoder", device, dtype)
