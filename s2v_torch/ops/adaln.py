"""AdaLN-Zero modulation of the 3-stream CogVideoX block and the output
AdaLayerNorm (counterpart of ``s2v_tpu/ops/adaln.py``)."""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from s2v_torch.ops.norms import layer_norm


def _modulation(linear: dict, temb: torch.Tensor) -> torch.Tensor:
    """silu(temb) @ W + b in fp32."""
    return F.linear(F.silu(temb.float()), linear["weight"].float(), linear["bias"].float())


def ada_layer_norm_zero_3stream(
    params: dict,
    video: torch.Tensor,
    text: torch.Tensor,
    ref: torch.Tensor,
    temb: torch.Tensor,
    eps: float = 1e-5,
) -> Tuple[torch.Tensor, ...]:
    """Returns (video_n, text_n, ref_n, video_gate, text_gate, ref_gate); the
    ref stream reuses the video stream's (shift, scale, gate)."""
    mod = _modulation(params["linear"], temb)  # [B, 6D] fp32
    shift, scale, gate, t_shift, t_scale, t_gate = mod.chunk(6, dim=-1)
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
        mod_stream(ref, shift, scale),
        gate[:, None, :].to(dt),
        t_gate[:, None, :].to(dt),
        gate[:, None, :].to(dt),
    )


def ada_layer_norm_out(params: dict, x: torch.Tensor, temb: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LN(x) * (1 + scale) + shift, with the CogVideoX "shift, scale" order."""
    shift, scale = _modulation(params["linear"], temb).chunk(2, dim=-1)
    xn = layer_norm(x, params["norm"]["weight"], params["norm"]["bias"], eps)
    dt = x.dtype
    return xn * (1.0 + scale[:, None, :]).to(dt) + shift[:, None, :].to(dt)
