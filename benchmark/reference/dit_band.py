"""The plain reference of the DiT under the windowed attention: ``dit.DiT``
whose video queries attend a band.  Inside a block the sequence is
``[text | ref | video]``; the G = text + ref tokens are global; the video
is F latent frames of ``tpf`` tokens.  A video query in frame f attends the
global keys and frames ``ws(f) .. ws(f) + span − 1``, with ``span =
min(2w + 1, F)`` and ``ws(f) = min(max(f − w, 0), F − span)``: the window
clamped at the clip's edges, so every frame sees ``span`` frames.  Global
queries attend every key.  Written from that description; imports nothing
of the program.  Departure from ``dit.DiT`` beyond the band: none (the
softmax of each query row is over its own keys, exact, in fp32; on the card
PyTorch's memory-efficient attention without a mask, one call per frame).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.nn.attention import SDPBackend, sdpa_kernel

from benchmark.reference import dit


def window_start(f: int, frames: int, w: int) -> int:
    span = min(2 * w + 1, frames)
    return min(max(f - w, 0), frames - span)


class DiT(dit.DiT):
    """``dit.DiT`` with the band of half-width ``window`` latent frames."""

    def __init__(self, sd, tcfg, window: int, lowp: bool = False):
        super().__init__(sd, tcfg, lowp=lowp)
        self.window = window
        self.band = None  # (global tokens, tokens per frame, frames), set by forward

    def forward(self, video, ref, text, t, positions):
        p = self.c["patch_size"]
        _, f, h, w, _ = video.shape
        tpf = (h // p) * (w // p)
        self.band = (text.shape[1] + ref.shape[1] * tpf, tpf, f)
        return super().forward(video, ref, text, t, positions)

    def _full(self, q, k, v):
        """softmax(q kᵀ / sqrt(d)) v of ``[B, H, n, d]`` queries over ``[B, H, m, d]`` keys."""
        if q.is_cuda and not self.lowp:
            with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
                return F.scaled_dot_product_attention(q, k, v)
        n, m = q.shape[2], k.shape[2]
        hc = max(1, min(self.heads, dit.ATTN_CHUNK_ELEMENTS // (n * m)))
        qc = max(1, min(n, dit.ATTN_CHUNK_ELEMENTS // (hc * m)))
        rows = []
        for bi in range(q.shape[0]):
            heads = [torch.cat([self._attend(q[bi, h0:h0 + hc, q0:q0 + qc], k[bi, h0:h0 + hc], v[bi, h0:h0 + hc])
                                for q0 in range(0, n, qc)], dim=1) for h0 in range(0, self.heads, hc)]
            rows.append(torch.cat(heads, dim=0))
        return torch.stack(rows)

    def attention(self, x, i, rope):
        b, s, _ = x.shape
        g, tpf, frames = self.band
        span = min(2 * self.window + 1, frames)
        pre = f"transformer_blocks.{i}.attn1"
        q, k, v = (self.linear(x, f"{pre}.to_{n}").view(b, s, self.heads, self.hd) for n in "qkv")
        q = dit.layer_norm(q, self.w(f"{pre}.norm_q.weight"), self.w(f"{pre}.norm_q.bias"), 1e-6)
        k = dit.layer_norm(k, self.w(f"{pre}.norm_k.weight"), self.w(f"{pre}.norm_k.bias"), 1e-6)
        if rope is not None:
            cos, sin, start = rope
            q = torch.cat([q[:, :start], dit._rotate(q[:, start:], cos, sin)], dim=1)
            k = torch.cat([k[:, :start], dit._rotate(k[:, start:], cos, sin)], dim=1)
        q, k, v = (t.permute(0, 2, 1, 3) for t in (q, k, v))  # [B, H, S, d]
        parts = [self._full(q[:, :, :g], k, v)]
        for f in range(frames):
            lo = g + window_start(f, frames, self.window) * tpf
            keys = [torch.cat([t[:, :, :g], t[:, :, lo:lo + span * tpf]], dim=2) for t in (k, v)]
            parts.append(self._full(q[:, :, g + f * tpf:g + (f + 1) * tpf], *keys))
        out = torch.cat(parts, dim=2).permute(0, 2, 1, 3).reshape(b, s, self.dim)
        return self.linear(out, f"{pre}.to_out.0")
