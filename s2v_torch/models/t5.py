"""T5 v1.1 encoder (counterpart of ``s2v_tpu/models/t5.py``): embedding, N
pre-RMSNorm blocks (self-attention with the relative-position bias of layer
0, gated-GELU MLP), final RMSNorm.  Linear weights ``[out, in]``, no biases."""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

from s2v_torch.config import T5Config
from s2v_torch.ops.norms import rms_norm
from s2v_torch.utils.device import resolve_device


def relative_position_bucket(relative_position: np.ndarray, num_buckets: int = 32, max_distance: int = 128) -> np.ndarray:
    """Bidirectional T5 bucket mapping."""
    num_buckets //= 2
    ret = (relative_position > 0).astype(np.int64) * num_buckets
    n = np.abs(relative_position)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    val_if_large = max_exact + (
        np.log(np.maximum(n, 1) / max_exact) / np.log(max_distance / max_exact) * (num_buckets - max_exact)
    ).astype(np.int64)
    val_if_large = np.minimum(val_if_large, num_buckets - 1)
    return ret + np.where(is_small, n, val_if_large)


def build_position_bias_index(seq_len: int, cfg: T5Config) -> np.ndarray:
    """``[S, S]`` bucket ids."""
    rel = np.arange(seq_len)[None, :] - np.arange(seq_len)[:, None]
    return relative_position_bucket(rel, cfg.relative_attention_num_buckets, cfg.relative_attention_max_distance)


def t5_self_attention(params: dict, x: torch.Tensor, bias: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Unscaled dot-product attention plus the additive ``[H, S, S]`` bias."""
    b, s, _ = x.shape
    inner = params["q"]["weight"].shape[0]
    shape = (b, s, num_heads, inner // num_heads)
    q = F.linear(x, params["q"]["weight"]).reshape(shape)
    k = F.linear(x, params["k"]["weight"]).reshape(shape)
    v = F.linear(x, params["v"]["weight"]).reshape(shape)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() + bias[None]
    weights = torch.softmax(logits, dim=-1).to(x.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", weights, v).reshape(b, s, inner)
    return F.linear(out, params["o"]["weight"])


def t5_mlp(params: dict, x: torch.Tensor) -> torch.Tensor:
    """gelu(x W0) * (x W1) Wo."""
    h = F.gelu(F.linear(x, params["wi_0"]["weight"]), approximate="tanh") * F.linear(x, params["wi_1"]["weight"])
    return F.linear(h, params["wo"]["weight"])


def t5_encode(params: dict, cfg: T5Config, input_ids: torch.Tensor) -> torch.Tensor:
    """``[B, S]`` token ids -> ``[B, S, d_model]`` final hidden states."""
    s = input_ids.shape[1]
    index = torch.from_numpy(build_position_bias_index(s, cfg)).to(input_ids.device)
    bias = params["relative_attention_bias"][index].permute(2, 0, 1).float()  # [H, S, S]
    x = F.embedding(input_ids.long(), params["embedding"]).to(cfg.dtype)
    for layer in params["blocks"]:
        x = x + t5_self_attention(layer["attn"], rms_norm(x, layer["ln1"]["weight"], cfg.layer_norm_epsilon),
                                  bias, cfg.num_heads)
        x = x + t5_mlp(layer["mlp"], rms_norm(x, layer["ln2"]["weight"], cfg.layer_norm_epsilon))
    return rms_norm(x, params["final_ln"]["weight"], cfg.layer_norm_epsilon)


def init_t5_params_random(
    cfg: T5Config,
    seed: int = 0,
    device: Optional[Union[str, torch.device]] = None,
) -> dict:
    """Random weights made on the device in ``cfg.dtype`` (normal/√fan_in
    kernels, unit norms, the JAX package's ``init_t5_params`` scheme)."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    dt = cfg.dtype

    def normal(shape, std):
        return torch.empty(shape, dtype=dt, device=device).normal_(0.0, std, generator=gen)

    def lin(out_d, in_d):
        return {"weight": normal((out_d, in_d), in_d ** -0.5)}

    def ones(n):
        return {"weight": torch.ones(n, dtype=dt, device=device)}

    inner = cfg.num_heads * cfg.d_kv
    d = cfg.d_model
    return {
        "embedding": normal((cfg.vocab_size, d), 1.0),
        "relative_attention_bias": normal((cfg.relative_attention_num_buckets, cfg.num_heads), 0.1),
        "blocks": [
            {
                "ln1": ones(d),
                "attn": {"q": lin(inner, d), "k": lin(inner, d), "v": lin(inner, d), "o": lin(d, inner)},
                "ln2": ones(d),
                "mlp": {"wi_0": lin(cfg.d_ff, d), "wi_1": lin(cfg.d_ff, d), "wo": lin(d, cfg.d_ff)},
            }
            for _ in range(cfg.num_layers)
        ],
        "final_ln": ones(d),
    }
