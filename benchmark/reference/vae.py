"""The plain reference of the CogVideoX VAE decoder: fp32 PyTorch from a
diffusers-layout state dict, written from the published
``AutoencoderKLCogVideoX`` description.

Latents are decoded in chunks of ``2`` latent frames (the remainder joins
the first chunk), each causal 3x3x3 conv padding a chunk in time with the
last two frames of the previous chunk (the first chunk: its first frame
twice) and in space with zeros; GroupNorm's statistics are a chunk's.
Every decoder norm is a spatial norm: GroupNorm(f) · conv_y(z) + conv_b(z),
z resized to f's frames and pixels by nearest neighbour, frame 0 on its
own when f has an odd count above 1.  Upsampling doubles height and width
(and frames in the two temporal levels, frame 0 kept single when odd).

``lowp`` convolves fp8 e4m3 operands (one scale per output channel of a
kernel, one per tensor of an input): the control.  Imports nothing of the
program.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference.dit import E4M3_MAX


def _fp8(x: torch.Tensor, per_row: bool) -> torch.Tensor:
    amax = x.abs().flatten(1).amax(1).view(-1, *[1] * (x.dim() - 1)) if per_row else x.abs().amax()
    s = amax.clamp_min(1e-30) / E4M3_MAX
    return (x / s).to(torch.float8_e4m3fn).float() * s


class Decoder:
    def __init__(self, sd: dict, vcfg: dict, lowp: bool = False):
        self.sd, self.c, self.lowp = sd, vcfg, lowp
        self.groups = vcfg["norm_num_groups"]

    def w(self, name):
        return self.sd[name].float()

    def conv(self, x, name, padding):
        w, b = self.w(f"{name}.weight"), self.w(f"{name}.bias")
        if w.dim() == 4:  # a per-frame 2D conv
            w = w[:, :, None]
        if self.lowp:
            x, w = _fp8(x, False), _fp8(w, True)
        return F.conv3d(x, w, b, padding=padding)

    def causal(self, x, name, cache, key):
        """A causal 3x3x3 conv; ``cache[key]`` carries the last two input
        frames to the next chunk."""
        prev = cache.get(key)
        pad = x[:, :, :1].repeat(1, 1, 2, 1, 1) if prev is None else prev
        x = torch.cat([pad, x], dim=2)
        cache[key] = x[:, :, -2:]
        return self.conv(x, name, (0, 1, 1))

    def spatial_norm(self, f, z, name):
        t, h, w = f.shape[2:]
        if t > 1 and t % 2 == 1:
            zq = torch.cat([F.interpolate(z[:, :, :1], size=(1, h, w)),
                            F.interpolate(z[:, :, 1:], size=(t - 1, h, w))], dim=2)
        else:
            zq = F.interpolate(z, size=(t, h, w))
        n = F.group_norm(f, self.groups, self.w(f"{name}.norm_layer.weight"), self.w(f"{name}.norm_layer.bias"), 1e-6)
        return n * self.conv(zq, f"{name}.conv_y.conv", 0) + self.conv(zq, f"{name}.conv_b.conv", 0)

    def resnet(self, x, z, name, cache):
        h = F.silu(self.spatial_norm(x, z, f"{name}.norm1"))
        h = self.causal(h, f"{name}.conv1.conv", cache, f"{name}.conv1")
        h = F.silu(self.spatial_norm(h, z, f"{name}.norm2"))
        h = self.causal(h, f"{name}.conv2.conv", cache, f"{name}.conv2")
        if f"{name}.conv_shortcut.weight" in self.sd:
            x = self.conv(x, f"{name}.conv_shortcut", 0)
        return x + h

    def upsample(self, x, name, compress_time):
        t = x.shape[2]
        if compress_time and t > 1 and t % 2 == 1:
            x = torch.cat([F.interpolate(x[:, :, :1], scale_factor=(1, 2, 2)),
                           F.interpolate(x[:, :, 1:], scale_factor=(2, 2, 2))], dim=2)
        elif compress_time and t > 1:
            x = F.interpolate(x, scale_factor=(2, 2, 2))
        else:
            x = F.interpolate(x, scale_factor=(1, 2, 2))
        return self.conv(x, name, (0, 1, 1))

    def chunk(self, z, cache):
        n_up = len(self.c["block_out_channels"])
        h = self.causal(z, "decoder.conv_in.conv", cache, "conv_in")
        for j in range(2):
            h = self.resnet(h, z, f"decoder.mid_block.resnets.{j}", cache)
        for i in range(n_up):
            for j in range(self.c["layers_per_block"] + 1):
                h = self.resnet(h, z, f"decoder.up_blocks.{i}.resnets.{j}", cache)
            if i < n_up - 1:
                h = self.upsample(h, f"decoder.up_blocks.{i}.upsamplers.0.conv", compress_time=i < 2)
        h = F.silu(self.spatial_norm(h, z, "decoder.norm_out"))
        return self.causal(h, "decoder.conv_out.conv", cache, "conv_out")

    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        """Latents ``[B, F, h, w, C]`` (scaled) -> frames ``[B, T, H, W, 3]``
        in [-1, 1] as decoded (not clipped), fp32."""
        z = latents.float().permute(0, 4, 1, 2, 3) / self.c["scaling_factor"]
        n = z.shape[2]
        chunk = 2
        rem = n % chunk
        cache: dict = {}
        outs = []
        for i in range(max(n // chunk, 1)):
            start = chunk * i + (0 if i == 0 else rem)
            outs.append(self.chunk(z[:, :, start:min(chunk * (i + 1) + rem, n)], cache))
        return torch.cat(outs, dim=2).permute(0, 2, 3, 4, 1)
