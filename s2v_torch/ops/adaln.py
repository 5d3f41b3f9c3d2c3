"""AdaLN-Zero modulation of the 3-stream CogVideoX block and the output
AdaLayerNorm (counterpart of ``s2v_tpu/ops/adaln.py``), with its
disentangled ``base_linear`` mode."""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from s2v_torch.ops.norms import layer_norm


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
    ``tp``: the modulation linears are column-sliced over the ``model`` dim."""
    mod = _modulation(params["linear"], temb, tp)  # [B, 6D] fp32
    shift, scale, gate, t_shift, t_scale, t_gate = mod.chunk(6, dim=-1)
    r_shift, r_scale, r_gate = shift, scale, gate
    if base_linear is not None:
        shift, scale, gate, t_shift, t_scale, t_gate = _modulation(base_linear, temb, tp).chunk(6, dim=-1)
    norm_w = params["norm"]["weight"]
    norm_b = params["norm"]["bias"]

    def mod_stream(x, sh, sc):
        xn = layer_norm(x, norm_w, norm_b, eps)
        dt = x.dtype
        return xn * (1.0 + sc[:, None, :]).to(dt) + sh[:, None, :].to(dt)

    dt = video.dtype
    return (
        mod_stream(video, shift, scale),
        mod_stream(text, t_shift, t_scale),
        mod_stream(ref, r_shift, r_scale),
        gate[:, None, :].to(dt),
        t_gate[:, None, :].to(dt),
        r_gate[:, None, :].to(dt),
    )


def ada_layer_norm_out(params: dict, x: torch.Tensor, temb: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LN(x) * (1 + scale) + shift, with the CogVideoX "shift, scale" order."""
    shift, scale = _modulation(params["linear"], temb).chunk(2, dim=-1)
    xn = layer_norm(x, params["norm"]["weight"], params["norm"]["bias"], eps)
    dt = x.dtype
    return xn * (1.0 + scale[:, None, :]).to(dt) + shift[:, None, :].to(dt)
