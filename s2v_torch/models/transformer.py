"""CogVideoX 3-stream DiT (counterpart of ``s2v_tpu/models/transformer.py``).

Parameters are a dict in torch layouts (linear weights ``[out, in]``) with
one dict per block in ``params["blocks"]``; the forward is a Python loop over
the blocks.  Inside a block the sequence is ``[text | ref | video]``.
"""

from __future__ import annotations

import functools
import re
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

from s2v_torch.config import TransformerConfig
from s2v_torch.ops.adaln import ada_layer_norm_out, ada_layer_norm_zero_3stream
from s2v_torch.ops.attention import SEQ_BACKENDS, WINDOWED_BACKENDS, joint_attention
from s2v_torch.ops.norms import layer_norm
from s2v_torch.ops.patchify import patchify_video, unpatchify_video
from s2v_torch.ops.quant import dense
from s2v_torch.ops.timestep import get_timestep_embedding, timestep_embedding_mlp
from s2v_torch.parallel.context import (
    FrameShard,
    active_seq_ring,
    copy_to_model,
    data_parallel,
    frame_shard,
    gather_rows_over,
    gather_video,
    take_rows,
    tensor_parallel,
)
from s2v_torch.parallel.sharding import take_slice, tp_leaf_placement
from s2v_torch.utils.device import resolve_device
from s2v_torch.utils.logging import phase


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


def _tp_slice(x: torch.Tensor, dim: int, placement, tp) -> torch.Tensor:
    """This ``model`` rank's part of a whole tensor along ``dim``, sliced as
    the leaf of ``placement`` is (per head for the fused qkv)."""
    if tp is None:
        return x
    return take_slice(x, dim, placement.blocks, tp.rank, tp.size, "runtime LoRA factor")


def _add_delta(leaf: dict, delta: torch.Tensor, placement=None, tp=None) -> dict:
    """Merge an ``[in, out]`` delta into a ``[out, in]`` weight, in fp32.
    Under megatron TP the whole delta is sliced as the weight is (JAX: the
    computed delta inherits the kernel's sharding)."""
    weight = leaf["weight"]
    if tp is not None and placement is not None and placement.model_dim is not None:
        delta = _tp_slice(delta, 1 - placement.model_dim, placement, tp)
    if delta.shape[::-1] != weight.shape:
        raise ValueError(f"runtime LoRA delta {tuple(delta.shape)} does not match weight {tuple(weight.shape)}")
    return {**leaf, "weight": (weight.float() + delta.T).to(weight.dtype)}


def _attach_factors(leaf: dict, pairs, placement=None, tp=None) -> dict:
    """Attach factor pairs for :func:`s2v_torch.ops.quant.dense` to apply
    after the linear.  A slotted q/k/v ``b`` is zero-padded to the fused
    qkv's full output width (taken from ``q`` on an int8 leaf).  Under
    megatron TP the factors are sliced as the weight is: ``b``'s columns
    for a column-parallel leaf, ``a``'s rows for a row-parallel one."""
    out_width = leaf["q" if "q" in leaf else "weight"].shape[0]
    if tp is not None and placement is not None and placement.model_dim == 0:
        out_width *= tp.size
    attached = []
    for ab, slot in pairs:
        a, b = ab["a"], ab["b"]
        if slot is not None:
            d = b.shape[-1]
            b = F.pad(b, (slot * d, out_width - (slot + 1) * d))
        if tp is not None and placement is not None and placement.model_dim == 0:
            b = _tp_slice(b, b.dim() - 1, placement, tp)
        elif tp is not None and placement is not None and placement.model_dim == 1:
            a = _tp_slice(a, a.dim() - 2, placement, tp)
        attached.append((a, b))
    return {**leaf, "lora": tuple(attached)}


def apply_runtime_lora_block(p: dict, lora: dict, tp=None) -> dict:
    """One block's params with its runtime factors (``{target: {"a" [in, r],
    "b" [r, out]}}``) applied, copy-on-write: the fused qkv, ``to_out`` and
    ``ff.net.2`` get their pairs attached (applied after the linear), the
    adaLN modulation linears (norm1/norm2) get ``W + (a @ b)ᵀ`` merged.
    ``tp``: the block holds this ``model`` rank's slices, and so do the
    factors or deltas applied to it."""
    out = {k: dict(v) if isinstance(v, dict) else v for k, v in p.items()}
    grouped: dict = {}
    for name, ab in lora.items():
        path, slot = _RT_BLOCK_TARGETS[name]
        grouped.setdefault(path, []).append((ab, slot))
    for (group, leaf_name), items in grouped.items():
        node = out[group]
        placement = tp_leaf_placement(("blocks", "0", group, leaf_name, "weight"), 2)
        if group in ("attn", "ff"):
            node[leaf_name] = _attach_factors(node[leaf_name], items, placement, tp)
            continue
        leaf = node[leaf_name]
        for ab, _slot in items:  # norm linears: slotless by construction
            leaf = _add_delta(leaf, _lora_delta(ab), placement, tp)
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


# the matmuls whose outputs remat "dots" keeps: JAX's
# dots_with_no_batch_dims_saveable saves dot_generals without batch dims,
# which are the linears' 2-D products here (F.linear reaches aten.mm/addmm)
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _remat_plan(remat: Union[bool, str], num_layers: int) -> Tuple[str, int]:
    """(mode, segments) of a remat setting: ``none``, ``full`` (each block
    checkpointed), ``dots`` (each block checkpointed, the linears' outputs
    saved) or ``seg`` with S segments (``seg`` picks the S minimising S +
    L/S, ``seg<N>`` pins S = N, which must divide L)."""
    if remat in (False, "none"):
        return "none", 0
    if remat in (True, "full"):
        return "full", 0
    if remat == "dots":
        return "dots", 0
    if isinstance(remat, str) and re.fullmatch(r"seg\d*", remat):
        if remat != "seg":
            segments = int(remat[3:])
            if segments < 1 or num_layers % segments:
                raise ValueError(f"remat={remat!r}: {segments} does not divide {num_layers} layers")
            return "seg", segments
        return "seg", min((d for d in range(1, num_layers + 1) if num_layers % d == 0),
                          key=lambda d: d + num_layers // d)
    raise ValueError(f"unknown remat mode {remat!r}")


def _feed_forward(p: dict, x: torch.Tensor, tp=None) -> torch.Tensor:
    """gelu(tanh) MLP; under megatron TP ``net_0`` column-parallel and
    ``net_2`` row-parallel with one all-reduce."""
    if tp is not None:
        x = copy_to_model(x, tp)
    h = dense(p["net_0"], x)
    with phase("s2v.gelu"):
        h = F.gelu(h, approximate="tanh")
    return dense(p["net_2"], h, row_parallel=tp)


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
    shard: Optional[FrameShard] = None,
    tp=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One CogVideoX block; ``ref`` may be zero-width ``[B, 0, D]`` (T2V).

    A windowed backend attends with text + ref as the global segment and
    the video's frames of ``tokens_per_frame`` tokens: the ref's length when
    a ref is present (one latent frame of the video's size), else the value
    given (``transformer_forward`` derives it from the video).  Under a
    sequence-parallel backend ``video`` is this rank's frames, ``shard``.
    ``tp``: the block holds this ``model`` rank's slices (megatron TP)."""
    t_len = text.shape[1]
    r_len = ref.shape[1]
    window = None
    # the disentangled mode reads the pre-merge modulation linears beside the
    # merged ones (s2v_tpu/models/transformer.py:331-373)
    disent = cfg.disentangled_modulation
    if attention_backend in WINDOWED_BACKENDS:
        tpf = r_len if r_len > 0 else tokens_per_frame
        if tpf <= 0:
            raise ValueError("windowed attention needs tokens-per-frame; call through transformer_forward "
                             "so it is derived from the video shape")
        window = (t_len + r_len, tpf, cfg.attention_window_frames)

    def modulated(norm: dict):
        """adaLN-Zero of the three streams, joined into ``[text | ref | video]``, and their gates."""
        with phase("s2v.adaln"):
            v_n, t_n, r_n, *gates = ada_layer_norm_zero_3stream(
                norm, video, text, ref, temb, cfg.norm_eps, base_linear=norm.get("base_linear") if disent else None,
                tp=tp)
            return torch.cat([t_n, r_n, v_n], dim=1), gates

    def gated(out: torch.Tensor, gates):
        """The streams' gated residual adds of a sublayer's joint output."""
        g_v, g_t, g_r = gates
        with phase("s2v.gate"):
            return (video + g_v * out[:, t_len + r_len:], text + g_t * out[:, :t_len],
                    ref + g_r * out[:, t_len:t_len + r_len])

    x, gates = modulated(p["norm1"])
    attn = joint_attention(
        p["attn"], x, cfg.num_attention_heads, rope_cos, rope_sin, cfg.qk_norm_eps, backend=attention_backend,
        window=window, shard=shard, tp=tp,
    )
    video, text, ref = gated(attn, gates)
    x, gates = modulated(p["norm2"])
    video, text, ref = gated(_feed_forward(p["ff"], x, tp), gates)
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
    pos_embedding: Optional[torch.Tensor] = None,  # [S_text + S_video, D] sincos (2b)
    param_gather=None,
) -> torch.Tensor:
    """Predict the denoising target ``[B, F, H, W, out_channels]``.

    With ``cfg.patch_size_t`` (CogVideoX1.5) a token is a 2x2x2 patch over
    (time, height, width): the latent frames must be a multiple of it (the
    pipeline pads them), a one-frame ``ref_latents`` is repeated into one
    temporal patch, and the RoPE tables are those of the temporal patches
    (``S2VPipeline.prepare_rope``); only one card and the exact backends take
    it (:func:`_check_frame_patches` raises for the others).

    ``pos_embedding`` (a model without RoPE, the 2b family) is added over
    ``[text | video]`` after the patch embedding; the ref stream gets none
    (``s2v_tpu/models/transformer.py:439-444``).

    A runtime factor tree under ``params[RUNTIME_LORA_KEY]`` is applied per
    layer inside the block loop.  ``remat`` (``s2v_tpu/models/transformer.py:465-509``):
    True/``"full"`` checkpoints each block (``torch.utils.checkpoint``,
    non-reentrant): only the streams between blocks are saved and each
    block's forward runs again in the backward; ``"dots"`` checkpoints each
    block with a selective policy that keeps the linears' outputs and
    recomputes the rest (less recomputation, far more memory);
    ``"seg"``/``"seg<N>"``
    nests the checkpoints: S segments of L/S checkpointed blocks, each
    segment checkpointed too, so S + L/S streams are saved instead of L, for
    one more forward; False/``"none"`` saves everything.  Every mode gives
    the same values and gradients.

    Sequence parallel (``s2v_tpu/models/transformer.py:433``): a backend of
    ``SEQ_BACKENDS`` runs on the active mesh's ``seq`` ring.  Above one rank
    each rank keeps its frames of the video stream (``FrameShard``, and the
    same rows of the RoPE or sincos table) through every block, computes the
    text and ref streams whole, and the output's video rows are gathered
    once before the unpatchify; a ring of 1 keeps the whole clip.  On a
    ring above 1 the backends of ``GATHERED_BACKENDS`` run on the same
    shards (their attention on the gathered rows), and any other raises.

    Under a ``data`` dim (``s2v_tpu/models/transformer.py:300-303,433``:
    ``constrain(.., "dp", ..)``) each rank keeps its equal rows of the
    batch (the batched CFG's 2B rows, a train batch) through the blocks,
    and the output is all-gathered over ``data``; without a gradient a
    batch the dim does not divide is padded with dummy rows (copies of its
    last) that the gather drops, under autograd it raises (ROADMAP C.32).  Under a ``model`` dim every block runs megatron TP on
    the params' slices (``parallel/sharding.py``, which the caller made:
    ``S2VPipeline.set_mesh``, ``shard_params``); the runtime factors stay
    whole and are sliced as their kernels.  ``param_gather(key, tree)``
    (FSDP, ``training/full.py``): called with ``"top"`` and the params
    outside the blocks once, and with each block's index and params inside
    the block (so a remat recompute gathers again), it returns them whole
    over ``data``."""
    tp, dp = tensor_parallel(), data_parallel()
    pt = cfg.patch_size_t
    if pt is not None:
        _check_frame_patches(cfg, attention_backend, tp, dp, param_gather)
    rows = video_latents.shape[0]
    if dp is not None:
        # without a gradient, rows the dim does not divide are padded with
        # dummy rows and dropped after the gather (ROADMAP C.32); a training
        # batch must divide (the trainer refuses it first, as JAX's does)
        pad = not _grad_flows(params, video_latents, ref_latents, text_embeds)
        video_latents, ref_latents, text_embeds, timestep = (
            take_rows(x, dp, pad=pad) for x in (video_latents, ref_latents, text_embeds, timestep))
    b, f, h, w, _ = video_latents.shape
    p = cfg.patch_size
    dt = cfg.dtype
    mode, segments = _remat_plan(remat, len(params["blocks"]))
    tpf = (h // p) * (w // p)
    shard = None
    if attention_backend in SEQ_BACKENDS or active_seq_ring() > 1:
        shard = frame_shard(f, tpf, attention_backend)
    if shard is not None and shard.ring > 1:
        video_latents, rope_cos, rope_sin, pos_embedding = _take_shard(
            shard, video_latents, rope_cos, rope_sin, pos_embedding, text_embeds.shape[1])

    runtime_lora = params.get(RUNTIME_LORA_KEY) or {}
    if param_gather is not None:
        params = {**params, **param_gather("top", {k: v for k, v in params.items()
                                                   if k not in ("blocks", RUNTIME_LORA_KEY)})}
    if tp is not None:
        _check_tp_slices(params, cfg, tp, param_gather)
    if "top" in runtime_lora:
        params = apply_runtime_lora_top(params, runtime_lora["top"])
    layer_factors = _layer_factors(runtime_lora.get("blocks"), len(params["blocks"]))

    t_emb = get_timestep_embedding(timestep, cfg.inner_dim, cfg.flip_sin_to_cos, float(cfg.freq_shift))
    temb = timestep_embedding_mlp(params["time_embedding"], t_emb.to(dt))

    pe = params["patch_embed"]
    text = dense(pe["text_proj"], text_embeds.to(dt))
    proj_w, proj_b = pe["proj"]["weight"], pe["proj"].get("bias")
    with phase("s2v.patch_embed"):
        video = patchify_video(video_latents.to(dt), proj_w, proj_b, p, pt)
        if ref_latents is None:
            ref = video[:, :0]
        else:
            if pt is not None and ref_latents.shape[1] == 1:
                # the subject's latent frame repeated into one temporal patch
                ref_latents = ref_latents.expand(-1, pt, -1, -1, -1)
            ref = patchify_video(ref_latents.to(dt), proj_w, proj_b, p, pt)
    if pos_embedding is not None and not cfg.use_rotary_positional_embeddings:
        t_len = text.shape[1]
        joint = torch.cat([text, video], dim=1) + pos_embedding.to(device=video.device, dtype=dt)[None]
        text, video = joint[:, :t_len], joint[:, t_len:]

    def run_block(index, layer, factors, video, text, ref):
        if param_gather is not None:
            layer = param_gather(index, layer)
        if factors is not None:
            layer = apply_runtime_lora_block(layer, factors, tp)
        return block_forward(layer, video, text, ref, temb, rope_cos, rope_sin, cfg, attention_backend,
                             tokens_per_frame=tpf, shard=shard, tp=tp)

    def run_blocks(first, layers, factors_list, video, text, ref):
        for index, (layer, factors) in enumerate(zip(layers, factors_list), first):
            if mode == "none":
                video, text, ref = run_block(index, layer, factors, video, text, ref)
            elif mode == "dots":
                video, text, ref = checkpoint(
                    run_block, index, layer, factors, video, text, ref, use_reentrant=False,
                    context_fn=functools.partial(create_selective_checkpoint_contexts, _save_dots))
            else:
                video, text, ref = checkpoint(run_block, index, layer, factors, video, text, ref,
                                              use_reentrant=False)
        return video, text, ref

    if mode == "seg":
        per = len(params["blocks"]) // segments
        for s0 in range(0, len(params["blocks"]), per):
            video, text, ref = checkpoint(run_blocks, s0, params["blocks"][s0:s0 + per], layer_factors[s0:s0 + per],
                                          video, text, ref, use_reentrant=False)
    else:
        video, text, ref = run_blocks(0, params["blocks"], layer_factors, video, text, ref)

    # final norm over [text | video]; the ref stream ends here
    joint = layer_norm(torch.cat([text, video], dim=1), params["norm_final"]["weight"],
                       params["norm_final"]["bias"], cfg.norm_eps)
    video = joint[:, text.shape[1]:]
    video = ada_layer_norm_out(params["norm_out"], video, temb, cfg.norm_eps)
    with phase("s2v.unpatchify"):  # across cards with the gathers of the video rows
        video = dense(params["proj_out"], video)
        if shard is not None and shard.ring > 1:
            video = gather_video(video, shard)
        if dp is not None:
            video = gather_rows_over(video, dp)[:rows]
        return unpatchify_video(video, f, h, w, p, cfg.out_channels, pt)


def token_grid(cfg: TransformerConfig, latent_frames: int, latent_h: int, latent_w: int) -> Tuple[int, int]:
    """(temporal patches, tokens per temporal patch) of a clip's latents: one
    patch per latent frame without ``patch_size_t``."""
    per = (latent_h // cfg.patch_size) * (latent_w // cfg.patch_size)
    return latent_frames // (cfg.patch_size_t or 1), per


# the backends that take no temporal patches: the windowed and sequence-parallel
# ones split the video by latent frames, B3 is untried with them
FRAME_BACKENDS = WINDOWED_BACKENDS + SEQ_BACKENDS + ("flash_int8",)


def _check_frame_patches(cfg: TransformerConfig, attention_backend: str, tp, dp, param_gather) -> None:
    """Temporal patches run on one card through the exact backends only
    (not :data:`FRAME_BACKENDS`, no mesh dim, no FSDP gather)."""
    if attention_backend in FRAME_BACKENDS:
        cfg.require_frame_patches(f"the {attention_backend!r} attention backend")
    if tp is not None or dp is not None or active_seq_ring() > 1:
        cfg.require_frame_patches("a mesh (data, seq or model dim)")
    if param_gather is not None:
        cfg.require_frame_patches("FSDP's parameter gather")


def _grad_flows(params, *inputs) -> bool:
    """Whether autograd records this forward: grad mode on and a parameter
    or an input that requires a gradient."""
    if not torch.is_grad_enabled():
        return False
    if any(x is not None and x.requires_grad for x in inputs):
        return True
    stack = [params]
    while stack:
        t = stack.pop()
        if isinstance(t, dict):
            stack.extend(t.values())
        elif isinstance(t, (list, tuple)):
            stack.extend(t)
        elif isinstance(t, torch.Tensor) and t.requires_grad:
            return True
    return False


def _check_tp_slices(params: dict, cfg: TransformerConfig, tp, param_gather) -> None:
    """A model dim above 1 needs the blocks' slices (a whole tree would
    run every head on every rank and add the row-parallel outputs tp
    times); a mesh that does not fit the model raises, naming the sizes."""
    for what, n in (("attention heads", cfg.num_attention_heads), ("feed-forward width", cfg.ff_inner_dim),
                    ("inner width", cfg.inner_dim)):
        if n % tp.size:
            raise ValueError(f"the model's {what} of {n} does not split over a model mesh dim of {tp.size} ranks")
    if tp.size == 1 or param_gather is not None or not params["blocks"]:
        return
    qkv = params["blocks"][0]["attn"]["qkv"]
    rows = qkv["q" if "q" in qkv else "weight"].shape[0]
    if rows != 3 * cfg.inner_dim // tp.size:
        raise ValueError(f"the transformer params hold {rows} qkv rows, not the {3 * cfg.inner_dim // tp.size} "
                         f"of a model mesh dim of {tp.size} ranks: slice them first (S2VPipeline.set_mesh, or "
                         f"parallel/sharding.py::shard_params)")


def _take_shard(shard: FrameShard, video_latents, rope_cos, rope_sin, pos_embedding, text_len: int):
    """This rank's frames of the latents (zero dummy frames) and its rows of
    the position tables (``[.. | video]`` along dim 0)."""
    lat = video_latents[:, shard.first_frame:shard.first_frame + shard.real_frames]
    pad = shard.local_frames - lat.shape[1]
    if pad:
        lat = torch.cat([lat, lat.new_zeros((lat.shape[0], pad, *lat.shape[2:]))], dim=1)

    def rows(table, lead):
        if table is None:
            return None
        lead = table.shape[0] - shard.video_rows if lead is None else lead
        return torch.cat([table[:lead], shard.take(table[lead:], dim=0)], dim=0)

    return lat, rows(rope_cos, None), rows(rope_sin, None), rows(pos_embedding, text_len)


def init_transformer_params_random(
    cfg: TransformerConfig,
    seed: int = 0,
    device: Optional[Union[str, torch.device]] = None,
    scale: float = 0.02,
) -> dict:
    """Random weights at any width, made on the device in ``cfg.dtype``:
    normal × ``scale`` kernels, zero biases, unit norm weights (modelled on
    ``init_transformer_params_stacked``).  For runs without a checkpoint;
    ``device="meta"`` gives the shapes without values."""
    meta = str(device) == "meta"  # shapes only, e.g. for the placements of a full-size tree
    device = torch.device("meta") if meta else resolve_device(device)
    gen = None if meta else torch.Generator(device=device).manual_seed(seed)
    dt = cfg.dtype
    d, td, hd = cfg.inner_dim, cfg.time_embed_dim, cfg.attention_head_dim
    pp = cfg.patch_size ** 2 * (cfg.patch_size_t or 1)

    def lin(out_dim, in_dim):
        w = torch.empty((out_dim, in_dim), dtype=dt, device=device)
        if gen is not None:
            w.normal_(0.0, scale, generator=gen)
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
    proj = lin(d, pp * cfg.in_channels)
    if not cfg.patch_bias:
        del proj["bias"]
    return {
        "patch_embed": {"proj": proj, "text_proj": lin(d, cfg.text_embed_dim)},
        "time_embedding": {"linear_1": lin(td, d), "linear_2": lin(td, td)},
        "blocks": blocks,
        "norm_final": norm(d),
        "norm_out": {"linear": lin(2 * d, td), "norm": norm(d)},
        "proj_out": lin(pp * cfg.out_channels, d),
    }
