"""The plain reference of the CogVideoX 3-stream DiT: fp32 PyTorch from a
diffusers-layout state dict, written from the published CogVideoX
description (``CogVideoXTransformer3DModel``) and the subject-to-video
extension: the sequence inside a block is ``[text | ref | video]``; the ref
stream is the subject's latent frame, patch-embedded with the video's
projection, modulated with the video's shift, scale and gate, given RoPE
frame 0 (the video frames 1..F) and dropped after the last block.

Departures from a literal transcription, none of which changes the result
beyond fp32 rounding: on the card attention is PyTorch's fp32
memory-efficient ``scaled_dot_product_attention`` (exact softmax attention
accumulated in fp32, so that no S x S matrix is held), elsewhere and in
the control the explicit form in blocks of heads and queries (each block
a whole softmax row); weights are cast to fp32 as each product needs them;
with ``checkpoint`` each block, and each explicit attention block inside
it, is recomputed in the backward.

``lowp`` computes every product (the linears, QKᵀ and PV) on operands
rounded to fp8 e4m3 with a scale per row, and stores the residual streams
in it after each update: the control, one precision below the bf16 and
fp16 the configurations state.

``lora``: adapters in the trainer's layout, per target ``{"a": [L, in, r],
"b": [L, r, out]}`` (no ``L`` for ``patch_proj``/``text_proj``; ``qkv``
spans the q, k and v outputs in that order), applied as ``y += s·(x a) b``.
Imports nothing of the program.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch.nn.attention import SDPBackend, sdpa_kernel
from torch.utils.checkpoint import checkpoint as _checkpoint

from benchmark.reference.schedule import rope_tables, sincos_table, timestep_sinusoid

E4M3_MAX = 448.0
ATTN_CHUNK_ELEMENTS = 1 << 28  # fp32 scores held at once: 1 GiB


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to fp8 e4m3 with one scale per row of the last axis, back in fp32."""
    s = x.abs().amax(-1, keepdim=True).clamp_min(1e-30) / E4M3_MAX
    return (x / s).to(torch.float8_e4m3fn).float() * s


def _ste(x: torch.Tensor) -> torch.Tensor:
    """fp8 rounding in the forward, identity in the backward."""
    return x + (fp8_round(x) - x).detach()


def layer_norm(x, w, b, eps):
    return F.layer_norm(x, (x.shape[-1],), w, b, eps)


class DiT:
    def __init__(self, sd: Dict[str, torch.Tensor], tcfg: dict, lowp: bool = False,
                 lora: Optional[dict] = None, lora_scale: float = 1.0, checkpoint: bool = False):
        self.sd, self.c, self.lowp = sd, tcfg, lowp
        self.lora, self.lora_scale, self.checkpoint = lora or {}, lora_scale, checkpoint
        self.heads, self.hd = tcfg["num_attention_heads"], tcfg["attention_head_dim"]
        self.dim = self.heads * self.hd

    def w(self, name: str) -> torch.Tensor:
        return self.sd[name].float()

    def mm(self, x, w):
        """x @ wᵀ, on fp8-rounded operands under ``lowp``."""
        if self.lowp:
            x, w = _ste(x), fp8_round(w)
        return x @ w.t()

    def lora_term(self, x, target, layer):
        ab = self.lora.get(target)
        if ab is None:
            return None
        a, b = (ab["a"], ab["b"]) if layer is None else (ab["a"][layer], ab["b"][layer])
        if self.lowp:
            return (_ste(_ste(x) @ a) @ b) * self.lora_scale
        return ((x @ a) @ b) * self.lora_scale

    def linear(self, x, prefix, target=None, layer=None, weight=None):
        y = self.mm(x, self.w(f"{prefix}.weight") if weight is None else weight) + self.w(f"{prefix}.bias")
        if target is not None:
            extra = self.lora_term(x, target, layer)
            if extra is not None:
                y = y + extra
        return y

    # -- attention -----------------------------------------------------------

    def _attend(self, q, k, v):
        """softmax(q kᵀ / sqrt(d)) v over one block of heads and queries;
        q ``[h, n, d]``, k and v ``[h, S, d]``."""
        if self.lowp:
            q, k, v = _ste(q), _ste(k), _ste(v)
        p = torch.softmax((q @ k.transpose(-1, -2)) * self.hd ** -0.5, dim=-1)
        if self.lowp:
            p = _ste(p)
        return p @ v

    def attention(self, x, i, rope):
        b, s, _ = x.shape
        pre = f"transformer_blocks.{i}.attn1"
        qkv = [self.linear(x, f"{pre}.to_{n}") for n in "qkv"]
        extra = self.lora_term(x, "qkv", i)
        if extra is not None:
            qkv = [y + e for y, e in zip(qkv, extra.chunk(3, dim=-1))]
        q, k, v = (y.view(b, s, self.heads, self.hd) for y in qkv)
        q = layer_norm(q, self.w(f"{pre}.norm_q.weight"), self.w(f"{pre}.norm_q.bias"), 1e-6)
        k = layer_norm(k, self.w(f"{pre}.norm_k.weight"), self.w(f"{pre}.norm_k.bias"), 1e-6)
        if rope is not None:
            cos, sin, start = rope
            q = torch.cat([q[:, :start], _rotate(q[:, start:], cos, sin)], dim=1)
            k = torch.cat([k[:, :start], _rotate(k[:, start:], cos, sin)], dim=1)
        q, k, v = (t.permute(0, 2, 1, 3) for t in (q, k, v))  # [B, H, S, d]
        if q.is_cuda and not self.lowp:
            with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
                out = F.scaled_dot_product_attention(q, k, v)
            return self.linear(out.permute(0, 2, 1, 3).reshape(b, s, self.dim), f"{pre}.to_out.0", "to_out", i)
        hc = max(1, min(self.heads, ATTN_CHUNK_ELEMENTS // (s * s)))
        qc = max(1, min(s, ATTN_CHUNK_ELEMENTS // (hc * s)))
        rows = []
        for bi in range(b):
            heads = []
            for h0 in range(0, self.heads, hc):
                kh, vh = k[bi, h0:h0 + hc], v[bi, h0:h0 + hc]
                parts = []
                for q0 in range(0, s, qc):
                    qh = q[bi, h0:h0 + hc, q0:q0 + qc]
                    if self.checkpoint and torch.is_grad_enabled():
                        parts.append(_checkpoint(self._attend, qh, kh, vh, use_reentrant=False))
                    else:
                        parts.append(self._attend(qh, kh, vh))
                heads.append(torch.cat(parts, dim=1))
            rows.append(torch.cat(heads, dim=0))
        out = torch.stack(rows).permute(0, 2, 1, 3).reshape(b, s, self.dim)
        return self.linear(out, f"{pre}.to_out.0", "to_out", i)

    # -- blocks ----------------------------------------------------------------

    def _modulate(self, name, temb, target, i, n):
        return self.linear(F.silu(temb), name, target, i).chunk(n, dim=-1)

    def block(self, i, video, text, ref, temb, rope):
        pre = f"transformer_blocks.{i}"
        eps = self.c["norm_eps"]
        t_len, r_len = text.shape[1], ref.shape[1]
        for n, sub in (("norm1", "attn"), ("norm2", "ff")):
            sh, sc, g, tsh, tsc, tg = self._modulate(f"{pre}.{n}.linear", temb, f"{n}.linear", i, 6)
            w, b = self.w(f"{pre}.{n}.norm.weight"), self.w(f"{pre}.{n}.norm.bias")

            def mod(x, shift, scale):
                return layer_norm(x, w, b, eps) * (1 + scale[:, None]) + shift[:, None]

            x = torch.cat([mod(text, tsh, tsc), mod(ref, sh, sc), mod(video, sh, sc)], dim=1)
            if sub == "attn":
                y = self.attention(x, i, rope)
            else:
                hidden = F.gelu(self.linear(x, f"{pre}.ff.net.0.proj"), approximate="tanh")
                y = self.linear(hidden, f"{pre}.ff.net.2", "ff.net.2", i)
            text = text + tg[:, None] * y[:, :t_len]
            ref = ref + g[:, None] * y[:, t_len:t_len + r_len]
            video = video + g[:, None] * y[:, t_len + r_len:]
            if self.lowp:  # the streams stored in fp8, as the program stores them in its dtype
                text, ref, video = _ste(text), _ste(ref), _ste(video)
        return video, text, ref

    # -- the model -------------------------------------------------------------

    def patch_embed(self, x):
        """``[B, F, H, W, C]`` -> ``[B, F·h·w, D]``: the conv of stride p as a
        product over each patch's (ph, pw, c) features."""
        bsz, f, h, w, c = x.shape
        p = self.c["patch_size"]
        x = x.reshape(bsz, f, h // p, p, w // p, p, c).permute(0, 1, 2, 4, 3, 5, 6)
        x = x.reshape(bsz, f * (h // p) * (w // p), p * p * c)
        weight = self.w("patch_embed.proj.weight").permute(0, 2, 3, 1).reshape(self.dim, -1)
        return self.linear(x, "patch_embed.proj", "patch_proj", None, weight=weight)

    def forward(self, video, ref, text, t, positions):
        """v-prediction ``[B, F, H, W, C]`` of noised latents ``video``, the
        subject's latents ``ref`` ``[B, 1, H, W, C]``, prompt embeddings
        ``text`` and integer timesteps ``t``.  ``positions``: ``("rope",
        cos, sin)`` tables over ``[ref | video]`` or ``("sincos", table)``
        over the video tokens."""
        c = self.c
        bsz, f, h, w, _ = video.shape
        p = c["patch_size"]
        temb = self.linear(F.silu(self.linear(timestep_sinusoid(t, self.dim), "time_embedding.linear_1")),
                           "time_embedding.linear_2")
        txt = self.linear(text.float(), "patch_embed.text_proj", "text_proj")
        vid = self.patch_embed(video.float())
        rf = self.patch_embed(ref.float())
        rope = None
        if positions[0] == "rope":
            rope = (positions[1].to(vid.device), positions[2].to(vid.device), txt.shape[1])
        else:
            vid = vid + positions[1].to(vid.device)[None]
        for i in range(c["num_layers"]):
            if self.checkpoint and torch.is_grad_enabled():
                vid, txt, rf = _checkpoint(self.block, i, vid, txt, rf, temb, rope, use_reentrant=False)
            else:
                vid, txt, rf = self.block(i, vid, txt, rf, temb, rope)
        vid = layer_norm(vid, self.w("norm_final.weight"), self.w("norm_final.bias"), c["norm_eps"])
        shift, scale = self._modulate("norm_out.linear", temb, None, None, 2)
        vid = layer_norm(vid, self.w("norm_out.norm.weight"), self.w("norm_out.norm.bias"), c["norm_eps"])
        vid = vid * (1 + scale[:, None]) + shift[:, None]
        out = self.linear(vid, "proj_out")  # features (c, ph, pw)
        co = c["out_channels"]
        out = out.reshape(bsz, f, h // p, w // p, co, p, p).permute(0, 1, 2, 5, 3, 6, 4)
        return out.reshape(bsz, f, h, w, co)


def _rotate(x, cos, sin):
    """Rotate channel pairs (2i, 2i+1) of ``[B, S, H, d]`` by ``[S, d/2]`` tables."""
    xe, xo = x[..., 0::2], x[..., 1::2]
    cos, sin = cos[None, :, None], sin[None, :, None]
    return torch.stack([xe * cos - xo * sin, xo * cos + xe * sin], dim=-1).flatten(-2)


def positions(tcfg: dict, height: int, width: int, num_frames: int):
    """The position tables of a clip: RoPE over ``[ref | video]`` (the
    subject at frame 0 of F + 1 frames) or the sincos table over the video."""
    p = tcfg["patch_size"]
    gh, gw = height // 8 // p, width // 8 // p
    frames = (num_frames - 1) // tcfg["temporal_compression_ratio"] + 1
    if tcfg["use_rotary_positional_embeddings"]:
        cos, sin = rope_tables(tcfg["attention_head_dim"], frames + 1, gh, gw)
        return ("rope", cos, sin)
    dim = tcfg["num_attention_heads"] * tcfg["attention_head_dim"]
    return ("sincos", sincos_table(dim, frames, gh, gw, tcfg["spatial_interpolation_scale"],
                                   tcfg["temporal_interpolation_scale"]))
