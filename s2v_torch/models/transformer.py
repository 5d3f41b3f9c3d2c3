"""CogVideoX 3-stream DiT (counterpart of ``s2v_tpu/models/transformer.py``).

Parameters are a dict in torch layouts (linear weights ``[out, in]``) with
one dict per block in ``params["blocks"]``; the forward is a Python loop over
the blocks.  Inside a block the sequence is ``[text | ref | video]``.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from s2v_torch.config import TransformerConfig
from s2v_torch.ops.adaln import ada_layer_norm_out, ada_layer_norm_zero_3stream
from s2v_torch.ops.attention import WINDOWED_BACKENDS, joint_attention
from s2v_torch.ops.norms import layer_norm
from s2v_torch.ops.patchify import patchify_video, unpatchify_video
from s2v_torch.ops.quant import dense
from s2v_torch.ops.timestep import get_timestep_embedding, timestep_embedding_mlp
from s2v_torch.utils.device import resolve_device


# ---------------------------------------------------------------------------
# runtime LoRA (unmerged adapters applied inside the forward)
# ---------------------------------------------------------------------------

# params key under which a runtime factor tree rides: {"blocks": {target:
# {"a": [L, in, r], "b": [L, r, out]}}, "top": {target: {"a", "b"}}}, the
# alpha/r scale folded into "a"
RUNTIME_LORA_KEY = "runtime_lora"

# runtime target -> (block-params path, fused-qkv slot); slot i puts the
# delta in output rows [i*D, (i+1)*D) of the fused qkv (q | k | v); None =
# full width
_RT_BLOCK_TARGETS = {
    "to_q": (("attn", "qkv"), 0),
    "to_k": (("attn", "qkv"), 1),
    "to_v": (("attn", "qkv"), 2),
    "qkv": (("attn", "qkv"), None),  # trainer-form fused pair
    "to_out": (("attn", "to_out"), None),
    "norm1.linear": (("norm1", "linear"), None),
    "norm2.linear": (("norm2", "linear"), None),
    "ff.net.2": (("ff", "net_2"), None),
}

_RT_TOP_TARGETS = {
    "patch_proj": ("patch_embed", "proj"),
    "text_proj": ("patch_embed", "text_proj"),
}


def _lora_delta(ab: dict) -> torch.Tensor:
    """fp32 low-rank delta ``a @ b`` ``[..., in, out]``."""
    return ab["a"].float() @ ab["b"].float()


def _add_delta(leaf: dict, delta: torch.Tensor) -> dict:
    """Merge an ``[in, out]`` delta into a ``[out, in]`` weight, in fp32."""
    weight = leaf["weight"]
    if delta.shape[::-1] != weight.shape:
        raise ValueError(f"runtime LoRA delta {tuple(delta.shape)} does not match weight {tuple(weight.shape)}")
    return {**leaf, "weight": (weight.float() + delta.T).to(weight.dtype)}


def _attach_factors(leaf: dict, pairs) -> dict:
    """Attach factor pairs for :func:`s2v_torch.ops.quant.dense` to apply
    after the linear.  A slotted q/k/v ``b`` is zero-padded to the fused
    qkv's full output width (taken from ``q`` on an int8 leaf)."""
    out_width = leaf["q" if "q" in leaf else "weight"].shape[0]
    attached = []
    for ab, slot in pairs:
        a, b = ab["a"], ab["b"]
        if slot is not None:
            d = b.shape[-1]
            b = F.pad(b, (slot * d, out_width - (slot + 1) * d))
        attached.append((a, b))
    return {**leaf, "lora": tuple(attached)}


def apply_runtime_lora_block(p: dict, lora: dict) -> dict:
    """One block's params with its runtime factors (``{target: {"a" [in, r],
    "b" [r, out]}}``) applied, copy-on-write: the fused qkv, ``to_out`` and
    ``ff.net.2`` get their pairs attached (applied after the linear), the
    adaLN modulation linears (norm1/norm2) get ``W + (a @ b)ᵀ`` merged."""
    out = {k: dict(v) if isinstance(v, dict) else v for k, v in p.items()}
    grouped: dict = {}
    for name, ab in lora.items():
        path, slot = _RT_BLOCK_TARGETS[name]
        grouped.setdefault(path, []).append((ab, slot))
    for (group, leaf_name), items in grouped.items():
        node = out[group]
        if group in ("attn", "ff"):
            node[leaf_name] = _attach_factors(node[leaf_name], items)
            continue
        leaf = node[leaf_name]
        for ab, _slot in items:  # norm linears: slotless by construction
            leaf = _add_delta(leaf, _lora_delta(ab))
        node[leaf_name] = leaf
    return out


def apply_runtime_lora_top(params: dict, top: dict) -> dict:
    """The patch and text projections with their deltas merged."""
    out = dict(params)
    for name, ab in top.items():
        group, leaf_name = _RT_TOP_TARGETS[name]
        group_tree = dict(out[group])
        group_tree[leaf_name] = _add_delta(group_tree[leaf_name], _lora_delta(ab))
        out[group] = group_tree
    return out


def _layer_factors(lora_blocks: Optional[dict], num_layers: int) -> list:
    """Stacked ``[L, ...]`` factors -> one ``{target: {"a", "b"}}`` per layer
    (``unbind``: the backward stacks the per-layer grads once)."""
    if not lora_blocks:
        return [None] * num_layers
    split = {name: {k: t.unbind(0) for k, t in ab.items()} for name, ab in lora_blocks.items()}
    return [{name: {k: ts[i] for k, ts in ab.items()} for name, ab in split.items()} for i in range(num_layers)]


def _remat_enabled(remat: Union[bool, str]) -> bool:
    if remat in (False, "none"):
        return False
    if remat in (True, "full"):
        return True
    if remat == "dots" or (isinstance(remat, str) and remat.startswith("seg")):
        raise NotImplementedError(f"remat={remat!r} is not ported yet; use True/'full' or False/'none'")
    raise ValueError(f"unknown remat mode {remat!r}")


def _feed_forward(p: dict, x: torch.Tensor) -> torch.Tensor:
    """gelu(tanh) MLP."""
    return dense(p["net_2"], F.gelu(dense(p["net_0"], x), approximate="tanh"))


def block_forward(
    p: dict,
    video: torch.Tensor,
    text: torch.Tensor,
    ref: torch.Tensor,
    temb: torch.Tensor,
    rope_cos: Optional[torch.Tensor],
    rope_sin: Optional[torch.Tensor],
    cfg: TransformerConfig,
    attention_backend: str = "plain",
    tokens_per_frame: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One CogVideoX block; ``ref`` may be zero-width ``[B, 0, D]`` (T2V).

    A windowed backend attends with text + ref as the global segment and
    the video's frames of ``tokens_per_frame`` tokens: the ref's length when
    a ref is present (one latent frame of the video's size), else the value
    given (``transformer_forward`` derives it from the video)."""
    t_len = text.shape[1]
    r_len = ref.shape[1]
    window = None
    if attention_backend in WINDOWED_BACKENDS:
        tpf = r_len if r_len > 0 else tokens_per_frame
        if tpf <= 0:
            raise ValueError("windowed attention needs tokens-per-frame; call through transformer_forward "
                             "so it is derived from the video shape")
        window = (t_len + r_len, tpf, cfg.attention_window_frames)
    v_n, t_n, r_n, g_v, g_t, g_r = ada_layer_norm_zero_3stream(p["norm1"], video, text, ref, temb, cfg.norm_eps)
    x = torch.cat([t_n, r_n, v_n], dim=1)
    attn = joint_attention(
        p["attn"], x, cfg.num_attention_heads, rope_cos, rope_sin, cfg.qk_norm_eps, backend=attention_backend,
        window=window,
    )
    video = video + g_v * attn[:, t_len + r_len:]
    text = text + g_t * attn[:, :t_len]
    ref = ref + g_r * attn[:, t_len:t_len + r_len]

    v_n, t_n, r_n, g_v, g_t, g_r = ada_layer_norm_zero_3stream(p["norm2"], video, text, ref, temb, cfg.norm_eps)
    ff = _feed_forward(p["ff"], torch.cat([t_n, r_n, v_n], dim=1))
    video = video + g_v * ff[:, t_len + r_len:]
    text = text + g_t * ff[:, :t_len]
    ref = ref + g_r * ff[:, t_len:t_len + r_len]
    return video, text, ref


def transformer_forward(
    params: dict,
    cfg: TransformerConfig,
    video_latents: torch.Tensor,  # [B, F, H, W, C]
    ref_latents: Optional[torch.Tensor],  # [B, Fr, Hr, Wr, C]; None = T2V
    text_embeds: torch.Tensor,  # [B, T, text_embed_dim]
    timestep: torch.Tensor,  # [B]
    rope_cos: Optional[torch.Tensor] = None,  # [S_total, head_dim/2]
    rope_sin: Optional[torch.Tensor] = None,
    attention_backend: str = "plain",
    remat: Union[bool, str] = False,
) -> torch.Tensor:
    """Predict the denoising target ``[B, F, H, W, out_channels]``.

    A runtime factor tree under ``params[RUNTIME_LORA_KEY]`` is applied per
    layer inside the block loop.  ``remat`` True/``"full"`` checkpoints each
    block (``torch.utils.checkpoint``, non-reentrant): only the streams
    between blocks are saved and each block's forward runs again in the
    backward; False/``"none"`` saves everything."""
    b, f, h, w, _ = video_latents.shape
    p = cfg.patch_size
    dt = cfg.dtype
    use_remat = _remat_enabled(remat)

    runtime_lora = params.get(RUNTIME_LORA_KEY) or {}
    if "top" in runtime_lora:
        params = apply_runtime_lora_top(params, runtime_lora["top"])
    layer_factors = _layer_factors(runtime_lora.get("blocks"), len(params["blocks"]))

    t_emb = get_timestep_embedding(timestep, cfg.inner_dim, cfg.flip_sin_to_cos, float(cfg.freq_shift))
    temb = timestep_embedding_mlp(params["time_embedding"], t_emb.to(dt))

    pe = params["patch_embed"]
    text = dense(pe["text_proj"], text_embeds.to(dt))
    video = patchify_video(video_latents.to(dt), pe["proj"]["weight"], pe["proj"]["bias"], p)
    if ref_latents is None:
        ref = video[:, :0]
    else:
        ref = patchify_video(ref_latents.to(dt), pe["proj"]["weight"], pe["proj"]["bias"], p)

    def run_block(layer, factors, video, text, ref):
        if factors is not None:
            layer = apply_runtime_lora_block(layer, factors)
        return block_forward(layer, video, text, ref, temb, rope_cos, rope_sin, cfg, attention_backend,
                             tokens_per_frame=(h // p) * (w // p))

    for layer, factors in zip(params["blocks"], layer_factors):
        if use_remat:
            video, text, ref = checkpoint(run_block, layer, factors, video, text, ref, use_reentrant=False)
        else:
            video, text, ref = run_block(layer, factors, video, text, ref)

    # final norm over [text | video]; the ref stream ends here
    joint = layer_norm(torch.cat([text, video], dim=1), params["norm_final"]["weight"],
                       params["norm_final"]["bias"], cfg.norm_eps)
    video = joint[:, text.shape[1]:]
    video = ada_layer_norm_out(params["norm_out"], video, temb, cfg.norm_eps)
    video = dense(params["proj_out"], video)
    return unpatchify_video(video, f, h, w, p, cfg.out_channels)


def init_transformer_params_random(
    cfg: TransformerConfig,
    seed: int = 0,
    device: Optional[Union[str, torch.device]] = None,
    scale: float = 0.02,
) -> dict:
    """Random weights at any width, made on the device in ``cfg.dtype``:
    normal × ``scale`` kernels, zero biases, unit norm weights (modelled on
    ``init_transformer_params_stacked``).  For runs without a checkpoint."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    dt = cfg.dtype
    d, td, hd = cfg.inner_dim, cfg.time_embed_dim, cfg.attention_head_dim
    pp = cfg.patch_size ** 2

    def lin(out_dim, in_dim):
        w = torch.empty((out_dim, in_dim), dtype=dt, device=device).normal_(0.0, scale, generator=gen)
        return {"weight": w, "bias": torch.zeros(out_dim, dtype=dt, device=device)}

    def norm(dim):
        return {"weight": torch.ones(dim, dtype=dt, device=device), "bias": torch.zeros(dim, dtype=dt, device=device)}

    blocks = [
        {
            "norm1": {"linear": lin(6 * d, td), "norm": norm(d)},
            "attn": {"qkv": lin(3 * d, d), "norm_q": norm(hd), "norm_k": norm(hd), "to_out": lin(d, d)},
            "norm2": {"linear": lin(6 * d, td), "norm": norm(d)},
            "ff": {"net_0": lin(cfg.ff_inner_dim, d), "net_2": lin(d, cfg.ff_inner_dim)},
        }
        for _ in range(cfg.num_layers)
    ]
    return {
        "patch_embed": {"proj": lin(d, pp * cfg.in_channels), "text_proj": lin(d, cfg.text_embed_dim)},
        "time_embedding": {"linear_1": lin(td, d), "linear_2": lin(td, td)},
        "blocks": blocks,
        "norm_final": norm(d),
        "norm_out": {"linear": lin(2 * d, td), "norm": norm(d)},
        "proj_out": lin(pp * cfg.out_channels, d),
    }
