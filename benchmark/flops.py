"""Frozen work counts of the benchmark: operations and bytes of a DiT
forward, of the attention kernels B1 (forward) and B2 (backward), and of
the VAE decoder, worked out from a configuration's shapes alone.

These are the yardstick of the roofline and utilisation metrics.  They sit
with the benchmark, not the program, so that no change to the program can
move them.  The kernel counts are those the port's kernel checks use:
B1 runs four products of ``2·S²·d`` per (batch, head) pair counted as
``4·B·H·S²·d`` (QKᵀ and PV), B2 five (``10·B·H·S²·d``: QKᵀ again, dV, dP,
dQ, dK); bytes are the operands read and written once.

Peaks: NVIDIA H100 SXM data sheet, dense: 989 TFLOP/s in bf16 and fp16 on
the tensor cores (495 in TF32, for an fp32 configuration), 3.35 TB/s of
HBM3.
"""

from __future__ import annotations

PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 495e12}
PEAK_BYTES_PER_S = 3.35e12
ELEMENT_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def dit_tokens(tcfg: dict, video: dict) -> dict:
    """Token counts of one clip: text, ref (one latent frame) and video."""
    p = tcfg["patch_size"]
    h, w = video["height"] // 8 // p, video["width"] // 8 // p
    frames = (video["num_frames"] - 1) // tcfg["temporal_compression_ratio"] + 1
    return {"text": tcfg["max_text_seq_length"], "ref": h * w, "video": frames * h * w}


def b1_flops(b: int, s: int, h: int, d: int) -> float:
    return 4.0 * b * h * s * s * d


def b1_bytes(b: int, s: int, h: int, d: int, elem: int) -> float:
    """q, k, v read, o written, and the fp32 log-sum-exp row."""
    return 4.0 * b * s * h * d * elem + b * h * s * 4.0


def b2_flops(b: int, s: int, h: int, d: int) -> float:
    return 10.0 * b * h * s * s * d


def b2_bytes(b: int, s: int, h: int, d: int, elem: int) -> float:
    """q, k, v, o, dO read, dq, dk, dv written, and the lse row."""
    return 8.0 * b * s * h * d * elem + b * h * s * 4.0


def least_seconds(flops: float, nbytes: float, dtype: str) -> float:
    """The roofline's least time: the larger of operations over the peak
    and bytes over the memory rate."""
    return max(flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES_PER_S)


def dit_forward_flops(tcfg: dict, batch: int, tokens: dict) -> float:
    """Model FLOPs of one DiT forward over ``batch`` rows of
    ``[text | ref | video]``: the linears (two per multiply-add) and the
    attention products; norms and elementwise work are not counted."""
    d = tcfg["num_attention_heads"] * tcfg["attention_head_dim"]
    te = tcfg["time_embed_dim"]
    ff = d * tcfg.get("ff_mult", 4)
    p = tcfg["patch_size"]
    s = tokens["text"] + tokens["ref"] + tokens["video"]
    per_token_block = 3 * d * d + d * d + 2 * d * ff  # qkv, to_out, ff.net.0, ff.net.2
    per_row_block = 2 * 6 * d * te  # norm1 and norm2 modulation linears
    blocks = tcfg["num_layers"] * batch * (2.0 * s * per_token_block + 2.0 * per_row_block)
    attention = tcfg["num_layers"] * b1_flops(batch, s, tcfg["num_attention_heads"], tcfg["attention_head_dim"])
    patch_in = p * p * tcfg["in_channels"]
    embed = batch * 2.0 * ((tokens["ref"] + tokens["video"]) * patch_in * d + tokens["text"] * tcfg["text_embed_dim"] * d)
    head = batch * 2.0 * (tokens["video"] * d * p * p * tcfg["out_channels"] + 2 * d * te)
    time = batch * 2.0 * (d * te + te * te)
    return blocks + attention + embed + head + time


def vae_decoder_flops(vcfg: dict, latent_frames: int, latent_h: int, latent_w: int) -> float:
    """FLOPs of the CogVideoX decoder's convolutions on one clip: every
    causal 3x3x3 conv, the spatial norms' 1x1x1 convs, the shortcuts and
    the per-frame 3x3 upsampling convs, each ``2·Cout·Cin·k`` per output
    voxel.  The frame counts follow the temporal upsampling (odd counts
    keep frame 0 single: 13 -> 25 -> 49)."""
    zc = vcfg["latent_channels"]
    chans = list(reversed(vcfg["block_out_channels"]))
    t, h, w = latent_frames, latent_h, latent_w
    total = 0.0

    def conv(cout, cin, k, voxels):
        return 2.0 * cout * cin * k * voxels

    def resnet(cin, cout, voxels):
        f = conv(cout, cin, 27, voxels) + conv(cout, cout, 27, voxels)
        # the spatial norms' conv_y and conv_b: norm1 at cin, norm2 at cout
        f += 2 * conv(cin, zc, 1, voxels) + 2 * conv(cout, zc, 1, voxels)
        if cin != cout:
            f += conv(cout, cin, 1, voxels)
        return f

    total += conv(chans[0], zc, 27, t * h * w)  # conv_in
    total += 2 * resnet(chans[0], chans[0], t * h * w)  # mid block
    c = chans[0]
    levels = len(chans)
    for i, out_c in enumerate(chans):
        for j in range(vcfg["layers_per_block"] + 1):
            total += resnet(c if j == 0 else out_c, out_c, t * h * w)
        c = out_c
        if i < levels - 1:
            if i < 2 and t > 1:  # the temporal levels of a 4x compression
                t = 2 * t - 1 if t % 2 == 1 else 2 * t
            h, w = 2 * h, 2 * w
            total += conv(c, c, 9, t * h * w)
    total += 2 * conv(c, zc, 1, t * h * w)  # norm_out's conv_y, conv_b
    total += conv(vcfg["out_channels"], c, 27, t * h * w)  # conv_out
    return total
