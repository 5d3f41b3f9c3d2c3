"""AdaLN-Zero modulation of the 3-stream CogVideoX block and the output
AdaLayerNorm (counterpart of ``s2v_tpu/ops/adaln.py``), with its
disentangled ``base_linear`` mode.

The modulation linear runs here (cuBLAS, fp32); the LayerNorm, the
modulation and the join of the streams go to ``kernels/adaln.py``, which
takes its hand-written kernel for a CUDA bf16/fp16 call with no gradient
needed (D a multiple of 8 up to its limit) and the plain chain for every
other call: the CPU, fp32, the trainers under autograd and remat's
recompute.  Which one runs depends only on what the call can observe.  The
kernel computes in fp32 throughout and rounds once to the storage dtype;
the plain chain rounds after each op of the apply, so the kernel's result
is the same or finer."""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from s2v_torch.kernels.adaln import adaln_zero_join, modulate_reference


def _modulation(linear: dict, temb: torch.Tensor, tp=None) -> torch.Tensor:
    """silu(temb) @ W + b in fp32.  Under megatron TP (``tp``, the ``model``
    dim) the linear holds this rank's output rows (JAX's ``_COL_PARALLEL``
    adaLN linears): its ``[B, 6D/tp]`` output is all-gathered over
    ``model`` before the modulation."""
    from s2v_torch.parallel.context import copy_to_model, gather_columns

    x = F.silu(temb.float())
    if tp is None:
        return F.linear(x, linear["weight"].float(), linear["bias"].float())
    mod = F.linear(copy_to_model(x, tp), linear["weight"].float(), linear["bias"].float())
    return gather_columns(mod, tp)


def _stream_modulations(params: dict, temb: torch.Tensor, base_linear: Optional[dict], tp) -> Tuple[tuple, tuple]:
    """((shift, scale) of video, text and ref), (video, text and ref gates),
    each ``[B, D]`` fp32; the ref stream takes the video stream's unless
    ``base_linear`` (the disentangled mode) gives video and text their own."""
    mod = _modulation(params["linear"], temb, tp)  # [B, 6D] fp32
    shift, scale, gate, t_shift, t_scale, t_gate = mod.chunk(6, dim=-1)
    r_shift, r_scale, r_gate = shift, scale, gate
    if base_linear is not None:
        shift, scale, gate, t_shift, t_scale, t_gate = _modulation(base_linear, temb, tp).chunk(6, dim=-1)
    return ((shift, scale), (t_shift, t_scale), (r_shift, r_scale)), (gate, t_gate, r_gate)


def ada_layer_norm_zero_3stream(
    params: dict,
    video: torch.Tensor,
    text: torch.Tensor,
    ref: torch.Tensor,
    temb: torch.Tensor,
    eps: float = 1e-5,
    base_linear: Optional[dict] = None,
    tp=None,
) -> Tuple[torch.Tensor, ...]:
    """Returns (video_n, text_n, ref_n, video_gate, text_gate, ref_gate); the
    ref stream reuses the video stream's (shift, scale, gate).

    With ``base_linear`` (the disentangled mode, ``s2v_tpu/ops/adaln.py:44-60``)
    video and text are modulated by that pre-merge linear and the ref
    stream by the first chunk of ``params["linear"]`` (the merged one).
    ``tp``: the modulation linears are column-sliced over the ``model`` dim.
    Always the plain chain; the DiT's blocks call
    :func:`ada_layer_norm_zero_joined`."""
    mods, gates = _stream_modulations(params, temb, base_linear, tp)
    dt = video.dtype
    return (*(modulate_reference(x, params["norm"], shift, scale, eps)
              for x, (shift, scale) in zip((video, text, ref), mods)),
            *(g[:, None, :].to(dt) for g in gates))


def ada_layer_norm_zero_joined(
    params: dict,
    video: torch.Tensor,
    text: torch.Tensor,
    ref: torch.Tensor,
    temb: torch.Tensor,
    eps: float = 1e-5,
    base_linear: Optional[dict] = None,
    tp=None,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """:func:`ada_layer_norm_zero_3stream`'s three streams joined into
    ``[B, T + R + V, D]`` in the order ``[text | ref | video]``, and the
    (video, text, ref) gates ``[B, 1, D]``: one launch of
    ``kernels/adaln.py``'s kernel where it engages (a CUDA bf16/fp16 call
    with no gradient needed, D a multiple of 8 up to its limit), else the
    plain chain and a ``torch.cat``.  The kernel computes in fp32 and
    rounds once, the same as or finer than the chain, which rounds after
    each op of the apply (the module docstring of ``kernels/adaln.py``).
    A zero-width ref, a sequence-parallel video shard and the gathered
    modulation of megatron TP pass through unchanged."""
    (v_mod, t_mod, r_mod), gates = _stream_modulations(params, temb, base_linear, tp)
    joined = adaln_zero_join((text, ref, video), (t_mod, r_mod, v_mod), params["norm"], eps)
    dt = video.dtype
    return joined, tuple(g[:, None, :].to(dt) for g in gates)


def ada_layer_norm_out(params: dict, x: torch.Tensor, temb: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LN(x) * (1 + scale) + shift, with the CogVideoX "shift, scale" order;
    one stream through ``kernels/adaln.py`` (its kernel where it engages,
    as :func:`ada_layer_norm_zero_joined`)."""
    shift, scale = _modulation(params["linear"], temb).chunk(2, dim=-1)
    return adaln_zero_join((x,), ((shift, scale),), params["norm"], eps)
