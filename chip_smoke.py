#!/usr/bin/env python3
"""Smoke run of the s2v_torch port on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line:
  1. device   — the card's name, count, and nvidia-smi's name and power limit;
  2. build    — every kernel built from the checkout's sources (one compiler
                process per source, all started together);
  3. kernel   — kernel B1 (flash attention) against its plain PyTorch version
                on the card, in every softmax mode: small ragged / masked /
                Sq != Skv shapes with lse (Skv below one key tile among
                them), an input that forces the bounded
                mode's online re-run, and the main-path shape B=2, H=48,
                S=19,126, d=64, timed beside its bound, the plain version and
                one ``F.scaled_dot_product_attention`` call (a yardstick only:
                the port never calls it);
  4. kernel_bwd — kernel B2 (flash attention backward) against its plain
                PyTorch version and against the emulation of its blocked
                schedule: small ragged shapes with Sq != Skv, and the
                training shape B=1, H=48, S=19,126, d=64 (q/k LayerNormed,
                lse from B1, dO seeded); two launches there must agree bit
                for bit; timed beside its bound, the plain version and the
                backward of one SDPA call (a yardstick only), with its time
                split among its pre-pass, dq and dk/dv kernels;
  5. kernel_banded — kernel B4 (banded windowed attention; global queries
                through B1) against its plain version and, on the small
                cases, the emulation of its schedule: small ragged
                geometries (clamped windows, w = 0, a window wider than the
                clip, the main shape's remainders mod 128), and the main
                shape B=2, G=1,576, tpf=1,350, F=13, w=2, timed (with the
                banded launch's TFLOP/s) beside its bound, the plain version,
                the gather path on B1, and one SDPA call with a boolean band
                mask over the video queries (a yardstick only);
  6. kernel_banded_bwd — kernel B5 (its backward; global queries through
                B2) the same way at the training shape (B=1); two launches
                there must agree bit for bit, and the banded launch's time is
                split among its pre-pass, dq and dk/dv kernels;
  7. kernel_banded_local — kernel B6 (banded attention for one
                sequence-parallel shard of video-query frames at a runtime
                frame offset, against the full K/V) against its plain
                version: the small geometries at every offset of a 2- and a
                4-rank ring, dummy frames included (a ring with more ranks
                than frames is refused before the launch); then the main
                band (B=2) for P = 1, 2, 4, the shards' rows and lse
                stitched against B4's; timed at P = 1 and per shard at P = 4
                beside the bound, the plain version and one masked SDPA call
                over the shard's video queries (a yardstick only); the small
                cases also against the emulation of B6's schedule;
  8. kernel_banded_local_bwd — kernel B7 (B6's backward: the shard's dq
                and full-extent dk/dv partials) the same way at B=1: dq
                stitched against B5's, the partials summed with the global
                queries' B2 part against B5's dk/dv, and junk in the dummy
                frames' rows changing nothing; at one rank two launches must
                agree bit for bit, and the time is split among its kernels;
  9. kernel_int8 — kernel B3 (int8 q·kᵀ attention): first one s8 wgmma
                tile through its 64-byte-swizzle layer against an integer
                matmul; then against its plain PyTorch version on the same
                int8 pre-pass, with its pre-pass kernels equal to the plain
                pre-pass bit for bit: small ragged shapes with Sq != Skv,
                negative-logit rows with a ragged key tail, a B=2 batch
                whose halves differ in magnitude (one shared scale), all
                also against the emulation of its schedule; and the main
                shape, where two launches must agree bit for bit, timed
                (pre-pass kernels, main launch, whole function) beside the
                torch pre-pass, its bound (the larger of the tensor cores'
                time, the exponentials' on the SFUs and the bytes'), the
                plain version and B1 online at the same shape (no PyTorch
                call computes int8-QK attention);
  10. reference — a small bf16 pipeline on the card, flash kernel against
                the plain fp32 attention on the same weights and noise, the
                same with the windowed backends (B4 against the gather path
                on the plain attention), and with the int8 tree
                (``flash_int8`` against the plain attention on the same
                quantized tree; the int8-vs-bf16 latent RMS printed);
  11. e2e      — ``S2VPipeline.generate`` at full CogVideoX-5b width (42-block
                DiT, T5-XXL, the full VAE; random weights from fixed seeds):
                49 frames at 480x720, 2 DDIM steps, batched CFG; the launch
                counts are zeroed just before and read just after; then one
                more denoise step under ``torch.profiler`` (device time by
                kernel family);
 12. e2e_windowed — the same after ``set_attention("windowed", 2)``: per
                step 42 B1 launches (global queries) and 42 B4 launches;
 13. e2e_sp_windowed — the same on a one-rank ``seq`` mesh (an NCCL
                process group of world size 1 over a ``HashStore``, made
                before the first SP phase) after ``set_attention("sp_windowed",
                2)``: per step 42 B6 and 42 B1 launches, no B4; its 1-step
                latents held against e2e_windowed's on the same seed;
 14. e2e_int8 — the same on the int8 DiT (``quantize_transformer_params``,
                timed) with ``set_attention("flash_int8")``: per step 42 B3
                launches (and 42 of its pre-pass) and no B1; the bf16 tree
                is restored after;
 15. train    — on the same pipeline: one seeded 49x480x720 clip through
                ``latent_batches`` (RoPE tables added), then 3 LoRA train
                steps (rank 128 on all seven target families, flash both
                ways, remat, adamw with a bf16 first moment and clip 1.0);
                per step the counts are zeroed before and read after: B1
                twice per block (forward and recompute), B2 once per block;
                then one more step under ``torch.profiler`` (device time by
                kernel family, the device's idle share);
 16. train_windowed — the same with ``attention_backend="windowed"``: per
                step B1 and B4 twice per block, B2 and B5 once per block;
 17. train_sp_windowed — the same with ``"sp_windowed"`` under the mesh's
                context: per step B6 and B1 twice per block, B7 and B2 once
                per block, no B4 or B5; its first loss printed beside
                train_windowed's;
 18. train_qlora — QLoRA: the same steps as ``train`` over the int8 base
                (flash both ways): per step B1 twice and B2 once per block,
                no B3; the int8 base unchanged; its first loss printed
                beside the exact phase's (same batch, same draws).
Then the kernels line, the nvidia-smi line, and the result line.  Any failed
phase raises: the script exits non-zero and prints no result.  It needs a
CUDA device and the repository beside it.  ``--phases a,b`` runs only those
phases (after the build), for a short check of one part.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
MAIN_SHAPE = (2, 19126, 48, 64)  # B, S, H, d: batched CFG over [text 226 | ref 1350 | video 17550]
TRAIN_SHAPE = (1, 19126, 48, 64)  # the LoRA train step: one clip, no CFG
# windowed attention at the 5b geometry: [text 226 | ref 1,350] global, 13 frames of 1,350, w = 2
BAND = (1576, 1350, 2)  # global_len, tokens_per_frame, window_frames
# (B, H, G, tpf, F, w): ragged frames and globals, clamped windows at both
# edges, w = 0, a small clip (span - 1 >= F - span: edge key frames take
# every query frame), a window wider than the clip, the main shape's
# remainders (168 and 198 are 40 and 70 mod 128, as 1,576 and 1,350 are), a
# frame of exactly three query tiles, full-size frames
BANDED_SMALL = [(2, 3, 24, 20, 5, 1), (1, 2, 24, 20, 3, 2), (1, 2, 24, 20, 4, 0), (1, 2, 24, 20, 4, 1),
                (1, 2, 1, 8, 2, 0), (1, 2, 300, 24, 4, 1), (1, 2, 7, 130, 3, 2), (1, 2, 129, 16, 7, 3),
                (1, 2, 50, 40, 5, 9), (1, 2, 168, 198, 5, 2), (1, 2, 40, 384, 3, 1), (1, 3, 1576, 1350, 5, 2)]
MODES = ("online", "bounded", "bounded_exp2")
MAIN_MODE = "bounded"  # the softmax mode the DiT's attention uses
# H100 SXM peaks (NVIDIA data sheet, dense): bf16 and int8 tensor cores, HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_BYTES_PER_S = 3.35e12
# the SFUs' ex2 rate per SM and clock (Hopper: 16), the exponentials' ceiling
SFU_EX2_PER_CLOCK = 16
# bf16 inputs against an fp32 plain version on the same bf16 values: the
# kernel rounds P to bf16 for P·V and writes a bf16 output, each a rounding
# of at most 2^-8 relative.  The limits scale with the reference, because the
# output's size depends on the shape: at the main shape the softmax spreads
# over 19,126 keys and an output element's RMS is only ~0.012, so a fixed
# O(1) tolerance would pass a kernel that drops a K/V tile.
#  - max|o - o_ref| <= 2^-6 * max|o_ref|: two to four bf16 ulps of the
#    largest element;
#  - ||o - o_ref|| / ||o_ref|| < 1e-2: a dropped or mis-weighted K/V tile
#    moves it by several percent at the main shape, rounding by ~1e-3.
OUT_MAX_REL = 2.0 ** -6
OUT_L2_REL = 1e-2
# lse is accumulated in fp32 in both; ex2.approx and the summation order differ
LSE_TOL = 1e-3
# the whole small pipeline in bf16 (weights, activations) against the same
# pipeline with fp32 attention, relative to the largest latent: bf16 rounding
# (2^-8) through 2 blocks x 2 steps, amplified up to 2g - 1 = 3x by the
# guidance mix at g = 2
PIPELINE_REL_TOL = 5e-2


def emit(obj):
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters):
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_build():
    from s2v_torch.kernels.banded_attention import SOURCE as BANDED_SRC
    from s2v_torch.kernels.banded_attention_bwd import SOURCE as BANDED_BWD_SRC
    from s2v_torch.kernels.flash_attention import SOURCE as FLASH_SRC
    from s2v_torch.kernels.flash_attention_bwd import SOURCE as FLASH_BWD_SRC
    from s2v_torch.kernels.int8_attention import SOURCE as INT8_SRC
    from s2v_torch.utils import native_build
    from s2v_torch.utils.sp_native import SOURCE as SP_SRC

    t0 = time.perf_counter()
    kernels = (FLASH_SRC, FLASH_BWD_SRC, BANDED_SRC, BANDED_BWD_SRC, INT8_SRC)
    results = native_build.build([*kernels, SP_SRC])
    # per kernel: its registers, spills and shared memory
    ptxas = {src.stem: [ln.strip() for ln in results[src.stem]["log"].splitlines()
                        if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
             for src in kernels}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_source_s": {k: v["seconds"] for k, v in results.items()}, "ptxas": ptxas})


def _qkv(b, sq, skv, h, seed, dev):
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    return tuple(torch.randn(b, s, h, 64, device=dev, generator=g).to(torch.bfloat16) for s in (sq, skv, skv))


def _agreement(o, o_ref, what):
    """Hold a kernel output against its plain version with the limits
    above; returns the numbers the JSON lines print."""
    o_ref = o_ref.float()
    diff = o.float() - o_ref
    ref_max = o_ref.abs().max().item()
    stats = {"max_abs_err": diff.abs().max().item(), "max_abs_tol": OUT_MAX_REL * ref_max,
             "rel_l2": (diff.norm() / o_ref.norm()).item(), "rel_l2_tol": OUT_L2_REL,
             "ref_max": ref_max, "ref_rms": o_ref.square().mean().sqrt().item()}
    if not (stats["max_abs_err"] <= stats["max_abs_tol"] and stats["rel_l2"] < OUT_L2_REL):
        raise AssertionError(f"{what}: {stats}")
    return stats


def _compare(q, k, v, mode, mask=None):
    from s2v_torch.kernels.flash_attention import flash_attention, flash_attention_reference

    o, lse = flash_attention(q, k, v, return_lse=True, key_pad_mask=mask, softmax_mode=mode)
    o_ref, lse_ref = flash_attention_reference(q, k, v, return_lse=True, key_pad_mask=mask, softmax_mode=mode)
    what = f"flash_attention[{mode}] {tuple(q.shape)}x{tuple(k.shape)}"
    stats = _agreement(o, o_ref, what)
    lse_err = (lse - lse_ref).abs().max().item()
    if not lse_err < LSE_TOL:
        raise AssertionError(f"{what}: lse max_abs_err {lse_err} (tol {LSE_TOL})")
    return {**stats, "lse_err": lse_err, "lse_tol": LSE_TOL}


def phase_kernel(dev):
    import torch
    import torch.nn.functional as F

    from s2v_torch.kernels import flash_attention as fa_module
    from s2v_torch.kernels.flash_attention import flash_attention, flash_attention_reference

    small = []
    for mode in MODES:
        # ragged against the kernel's 128-query blocks and 128-key tiles, Skv below one tile
        for (b, sq, skv, h, masked) in [(2, 200, 200, 3, False), (1, 77, 333, 2, True), (2, 1000, 129, 2, False),
                                        (1, 130, 40, 2, False), (1, 300, 1000, 2, True)]:
            q, k, v = _qkv(b, sq, skv, h, sq + skv, dev)
            mask = None
            if masked:
                mask = torch.zeros(skv, dtype=torch.bool, device=dev)
                mask[5:40] = True
                mask[-3:] = True
            small.append({"mode": mode, "q": [b, sq, h, 64], "skv": skv, "masked": masked,
                          **_compare(q, k, v, mode, mask)})
    emit({"phase": "kernel_small", "cases": small})

    # near-orthogonal q/k with large norms: the Cauchy-Schwarz offset sits
    # ~1e4 nats above every logit, every p underflows, the online re-run runs
    reruns = {}
    for mode in ("bounded", "bounded_exp2"):
        q, k, v = _qkv(1, 256, 256, 2, 5, dev)
        q[..., 32:] = 0
        k[..., :32] = 0
        q *= 40
        k *= 40
        before = flash_attention.reruns
        o = flash_attention(q, k, v, softmax_mode=mode)
        if flash_attention.reruns != before + 1:
            raise AssertionError(f"bounded re-run not taken ({mode})")
        o_ref = flash_attention_reference(q, k, v, softmax_mode="online")
        reruns[mode] = {"reruns": flash_attention.reruns - before,
                        **_agreement(o, o_ref, f"flash_attention[{mode}] re-run")}
    emit({"phase": "kernel_rerun", "cases": reruns})

    # the main-path shape, q/k qk-LayerNormed as in the DiT
    b, s, h, d = MAIN_SHAPE
    q, k, v = _qkv(b, s, s, h, 7, dev)
    q = F.layer_norm(q.float(), (d,)).to(torch.bfloat16)
    k = F.layer_norm(k.float(), (d,)).to(torch.bfloat16)
    main = {}
    for mode in MODES:
        stats = _compare(q, k, v, mode)
        flash_attention(q, k, v, softmax_mode=mode)  # warm-up
        main[mode] = {**stats, "ms": cuda_ms(lambda: flash_attention(q, k, v, softmax_mode=mode), 10)}
    plain_ms = cuda_ms(lambda: flash_attention_reference(q, k, v, softmax_mode=MAIN_MODE), 2)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    F.scaled_dot_product_attention(qt, kt, vt)
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), 10)
    flops = 4 * b * h * s * s * d
    # q, k, v read once and o written once in bf16, plus the fp32 log l row
    nbytes = 4 * b * s * h * d * 2 + b * h * s * 4
    bound_ms = max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S) * 1e3
    bound_by = "operations" if flops / PEAK_BF16_FLOPS >= nbytes / PEAK_BYTES_PER_S else "bytes"
    for mode in MODES:
        main[mode]["tflops"] = flops / main[mode]["ms"] / 1e9
    result = {"phase": "kernel_main", "shape": list(MAIN_SHAPE), "modes": main, "plain_ms": plain_ms,
              "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by,
              "tflops": flops / main[MAIN_MODE]["ms"] / 1e9, "reruns": flash_attention.reruns,
              "smem_bytes": fa_module._library().s2v_flash_attention_fwd_smem_bytes()}
    emit(result)
    return result


def _bwd_inputs(b, sq, skv, h, seed, dev, layer_norm=False):
    """q, k, v, o, lse (B1 in the train path's softmax mode) and a seeded dO."""
    import torch
    import torch.nn.functional as F

    from s2v_torch.kernels.flash_attention import flash_attention

    q, k, v = _qkv(b, sq, skv, h, seed, dev)
    if layer_norm:
        q = F.layer_norm(q.float(), (64,)).to(torch.bfloat16)
        k = F.layer_norm(k.float(), (64,)).to(torch.bfloat16)
    o, lse = flash_attention(q, k, v, return_lse=True, softmax_mode=MAIN_MODE)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    do = torch.randn(q.shape, device=dev, generator=g).to(torch.bfloat16)
    return q, k, v, o, lse, do


def _compare_bwd(q, k, v, o, lse, do):
    """B2 against its plain version, and against the emulation of its blocked
    schedule (``flash_attention_bwd_blocked``) with the same limits."""
    from s2v_torch.kernels.flash_attention_bwd import (
        flash_attention_bwd,
        flash_attention_bwd_blocked,
        flash_attention_bwd_reference,
    )

    got = flash_attention_bwd(q, k, v, o, lse, do)
    want = flash_attention_bwd_reference(q, k, v, o, lse, do)
    what = f"flash_attention_bwd {tuple(q.shape)}x{tuple(k.shape)}"
    stats = {name: _agreement(a, r, f"{what} {name}") for name, a, r in zip(("dq", "dk", "dv"), got, want)}
    del want
    emulated = flash_attention_bwd_blocked(q, k, v, o, lse, do)
    for name, a, e in zip(("dq", "dk", "dv"), got, emulated):
        schedule = _agreement(a, e, f"{what} {name} against the blocked schedule")
        stats[name]["schedule_max_abs_err"] = schedule["max_abs_err"]
        stats[name]["schedule_rel_l2"] = schedule["rel_l2"]
    return stats


def phase_kernel_bwd(dev):
    """Kernel B2 against its plain version: small ragged shapes (Sq != Skv),
    then the training shape, timed beside its bound, the plain version and
    the backward of one ``F.scaled_dot_product_attention`` (a yardstick
    only: the port never calls it)."""
    import torch
    import torch.nn.functional as F

    from s2v_torch.kernels import flash_attention_bwd as fab
    from s2v_torch.kernels.flash_attention import flash_attention
    from s2v_torch.kernels.flash_attention_bwd import flash_attention_bwd, flash_attention_bwd_reference

    small = []
    # ragged against the kernels' 128-row blocks and 64-row tiles, Skv below one tile
    for (b, sq, skv, h) in [(2, 200, 200, 3), (1, 77, 333, 2), (2, 1000, 129, 2), (1, 130, 40, 2)]:
        small.append({"q": [b, sq, h, 64], "skv": skv, **_compare_bwd(*_bwd_inputs(b, sq, skv, h, sq + skv, dev))})
    emit({"phase": "kernel_bwd_small", "cases": small})

    b, s, h, d = TRAIN_SHAPE
    q, k, v, o, lse, do = _bwd_inputs(b, s, s, h, 11, dev, layer_norm=True)
    stats = _compare_bwd(q, k, v, o, lse, do)
    # determinism: a second launch on the same inputs gives the same bits
    first = flash_attention_bwd(q, k, v, o, lse, do)
    second = flash_attention_bwd(q, k, v, o, lse, do)
    deterministic = {name: bool(torch.equal(a, c)) for name, a, c in zip(("dq", "dk", "dv"), first, second)}
    if not all(deterministic.values()):
        raise AssertionError(f"flash_attention_bwd: two launches on the same inputs differ: {deterministic}")
    del first, second
    # B1 as the train step calls it (with lse), at the same shape
    b1_ms = cuda_ms(lambda: flash_attention(q, k, v, return_lse=True, softmax_mode=MAIN_MODE), 10)
    flash_attention_bwd(q, k, v, o, lse, do)  # warm-up
    ms = cuda_ms(lambda: flash_attention_bwd(q, k, v, o, lse, do), 10)
    parts_ms = _bwd_parts_ms(q, k, v, o, lse, do)
    plain_ms = cuda_ms(lambda: flash_attention_bwd_reference(q, k, v, o, lse, do), 2)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    out = F.scaled_dot_product_attention(qt, kt, vt)
    gt = do.transpose(1, 2)
    torch.autograd.grad(out, (qt, kt, vt), gt, retain_graph=True)
    library_ms = cuda_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), gt, retain_graph=True), 10)
    del out, qt, kt, vt
    flops = 10 * b * h * s * s * d  # five products of 2·S²·d each, per (b, h)
    # q, k, v, o, dO read and dq, dk, dv written once in bf16, plus the fp32 lse
    nbytes = 8 * b * s * h * d * 2 + b * h * s * 4
    bound_ms = max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S) * 1e3
    bound_by = "operations" if flops / PEAK_BF16_FLOPS >= nbytes / PEAK_BYTES_PER_S else "bytes"
    result = {"phase": "kernel_bwd_main", "shape": list(TRAIN_SHAPE), "grads": stats, "ms": ms,
              "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by,
              "tflops": flops / ms / 1e9, "parts_ms": parts_ms, "deterministic": deterministic,
              "smem_bytes": fab._library().s2v_flash_attention_bwd_smem_bytes(),
              "b1_with_lse_ms": b1_ms, "b1_with_lse_tflops": 4 * b * h * s * s * d / b1_ms / 1e9}
    emit(result)
    return result


def _bwd_parts_ms(q, k, v, o, lse, do):
    """B2's time split among its three kernels (pre-pass, dq, dk/dv), each
    launched alone on a workspace that a whole call has filled."""
    import torch

    from s2v_torch.kernels import flash_attention_bwd as fab

    ws = fab.bwd_workspace(q)
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    scale = q.shape[-1] ** -0.5
    launch = lambda parts: fab._launch(q, k, v, o, do, lse, dq, dk, dv, scale, ws, parts)  # noqa: E731
    launch(fab.ALL_PARTS)
    out = {}
    for name, part in (("prepass", fab.PART_PREPASS), ("dq", fab.PART_DQ), ("dkv", fab.PART_DKV)):
        launch(part)  # warm-up
        out[name] = cuda_ms(lambda: launch(part), 10)
    return out


def _bound(flops, nbytes):
    """(bound_ms, bound_by): the larger of the operations over the bf16 peak
    and the bytes over the memory rate."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def _ln_qkv(b, s, h, seed, dev):
    """q, k, v at the DiT's scale: q/k LayerNormed over d, as after qk-norm."""
    import torch
    import torch.nn.functional as F

    q, k, v = _qkv(b, s, s, h, seed, dev)
    return F.layer_norm(q.float(), (64,)).to(torch.bfloat16), F.layer_norm(k.float(), (64,)).to(torch.bfloat16), v


def _library_ms(what, setup, shapes):
    """Time the one PyTorch call ``setup(shape)`` returns at the first shape
    of ``shapes`` that runs on the card; returns (ms, shape, reasons for the
    shapes that did not run)."""
    import torch

    reasons = []
    for shape in shapes:
        try:
            call = setup(shape)
            call()  # warm-up
            return cuda_ms(call, 10), list(shape), reasons
        except (torch.OutOfMemoryError, RuntimeError) as e:
            reasons.append(f"{what} at {list(shape)}: {type(e).__name__}: {str(e)[:200]}")
            torch.cuda.empty_cache()
    return None, None, reasons


def _masked_sdpa_args(b, h, geo, seed, dev, requires_grad=False):
    """Inputs of the library yardstick: the video queries against every key
    with the band as a boolean ``[S_vid, S]`` mask."""
    import torch

    from s2v_torch.kernels.banded_attention import band_mask

    s = geo.global_len + geo.n_frames * geo.tokens_per_frame
    q, k, v = _ln_qkv(b, s, h, seed, dev)
    qt, kt, vt = (x.transpose(1, 2) for x in (q[:, geo.global_len:], k, v))
    if requires_grad:
        qt, kt, vt = (x.detach().requires_grad_() for x in (qt, kt, vt))
    return qt, kt, vt, band_mask(geo, torch.arange(geo.global_len, s, device=dev), s)


def _schedule_stats(got, emulated, what):
    """A kernel's output against the emulation of its schedule, with the
    limits of its plain version; the numbers the JSON lines print."""
    stats = _agreement(got, emulated, f"{what} against the emulation of its schedule")
    return {"schedule_max_abs_err": stats["max_abs_err"], "schedule_max_abs_tol": stats["max_abs_tol"],
            "schedule_rel_l2": stats["rel_l2"]}


def _compare_banded(q, k, v, band, schedule=False):
    """B4 against its plain version (and, on the small cases, against
    ``banded_flash_attention_blocked``, the emulation of its schedule)."""
    from s2v_torch.kernels.banded_attention import (
        banded_flash_attention,
        banded_flash_attention_blocked,
        banded_flash_attention_reference,
    )

    o, lse = banded_flash_attention(q, k, v, *band, return_lse=True)
    o_ref, lse_ref = banded_flash_attention_reference(q, k, v, *band, return_lse=True)
    what = f"banded_flash_attention {tuple(q.shape)} band {band}"
    stats = _agreement(o, o_ref, what)
    lse_err = (lse - lse_ref).abs().max().item()
    if not lse_err < LSE_TOL:
        raise AssertionError(f"{what}: lse max_abs_err {lse_err} (tol {LSE_TOL})")
    stats = {**stats, "lse_err": lse_err, "lse_tol": LSE_TOL}
    if schedule:
        o_emu, lse_emu = banded_flash_attention_blocked(q, k, v, *band, return_lse=True)
        stats.update(_schedule_stats(o, o_emu, what), schedule_lse_err=(lse - lse_emu).abs().max().item())
        if not stats["schedule_lse_err"] < LSE_TOL:
            raise AssertionError(f"{what}: lse against the emulation {stats['schedule_lse_err']} (tol {LSE_TOL})")
    return stats


def phase_kernel_banded(dev):
    """Kernel B4 (with the global queries' B1 call) against its plain
    version: small geometries, then the main shape, timed beside its bound,
    the plain version, the gather path on B1 and one masked SDPA call over
    the video queries (a yardstick only: the port never calls it)."""
    import torch
    import torch.nn.functional as F

    from s2v_torch.kernels import banded_attention as ba
    from s2v_torch.kernels.banded_attention import (
        band_geometry,
        banded_flash_attention,
        banded_flash_attention_reference,
        launch_banded,
    )
    from s2v_torch.ops.windowed_attention import windowed_attention

    small = []
    for (b, h, g, tpf, f, w) in BANDED_SMALL:
        q, k, v = _qkv(b, g + f * tpf, g + f * tpf, h, g + tpf + f, dev)
        small.append({"b": b, "h": h, "band": [g, tpf, f, w],
                      **_compare_banded(q, k, v, (g, tpf, w), schedule=True)})
    emit({"phase": "kernel_banded_small", "cases": small})

    b, s, h, d = MAIN_SHAPE
    q, k, v = _ln_qkv(b, s, h, 7, dev)
    geo = band_geometry(s, *BAND)
    stats = _compare_banded(q, k, v, BAND)
    banded_flash_attention(q, k, v, *BAND)  # warm-up
    ms = cuda_ms(lambda: banded_flash_attention(q, k, v, *BAND), 10)
    lse_ms = cuda_ms(lambda: banded_flash_attention(q, k, v, *BAND, return_lse=True), 10)
    o = torch.empty_like(q)
    video_ms = cuda_ms(lambda: launch_banded(q, k, v, o, None, geo, d ** -0.5), 10)
    plain_ms = cuda_ms(lambda: banded_flash_attention_reference(q, k, v, *BAND), 2)
    windowed_attention(q, k, v, *BAND)  # warm-up
    gather_ms = cuda_ms(lambda: windowed_attention(q, k, v, *BAND), 10)
    del o

    def masked_sdpa(shape):
        qt, kt, vt, mask = _masked_sdpa_args(*shape, geo, 7, dev)
        return lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)

    library_ms, library_shape, library_failed = _library_ms(
        "masked SDPA over the video queries", masked_sdpa, [(b, h), (1, h), (1, h // 2)])
    pairs_vid, pairs_glob = geo.pairs()
    flops_vid, flops_glob = 4 * b * h * d * pairs_vid, 4 * b * h * d * pairs_glob
    # q, k, v read once and o written once in bf16 (the inference call: no lse)
    bound_ms, bound_by = _bound(flops_vid + flops_glob, 4 * b * s * h * d * 2)
    s_vid = s - geo.global_len
    video_bound_ms, _ = _bound(flops_vid, (2 * s_vid + 2 * s) * b * h * d * 2)
    result = {"phase": "kernel_banded_main", "shape": list(MAIN_SHAPE), "band": list(BAND), **stats,
              "ms": ms, "with_lse_ms": lse_ms, "video_launch_ms": video_ms, "gather_path_ms": gather_ms,
              "plain_ms": plain_ms, "library_ms": library_ms, "library_shape": library_shape,
              "library_not_run": library_failed, "bound_ms": bound_ms, "bound_by": bound_by,
              "video_bound_ms": video_bound_ms, "global_bound_ms": flops_glob / PEAK_BF16_FLOPS * 1e3,
              "video_tflops": flops_vid / video_ms / 1e9,
              "small_worst_schedule_share": max(c["schedule_max_abs_err"] / c["schedule_max_abs_tol"] for c in small),
              "smem_bytes": ba._library().s2v_banded_attention_fwd_smem_bytes()}
    emit(result)
    return result


def _banded_bwd_inputs(b, h, s, band, seed, dev, layer_norm=False):
    """q, k, v, o, lse (B4 with lse) and a seeded dO."""
    import torch

    from s2v_torch.kernels.banded_attention import banded_flash_attention

    q, k, v = _ln_qkv(b, s, h, seed, dev) if layer_norm else _qkv(b, s, s, h, seed, dev)
    o, lse = banded_flash_attention(q, k, v, *band, return_lse=True)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    do = torch.randn(q.shape, device=dev, generator=g).to(torch.bfloat16)
    return q, k, v, o, lse, do


def _compare_banded_bwd(q, k, v, o, lse, do, band, schedule=False):
    """B5 against its plain version (and, on the small cases, against
    ``banded_flash_attention_bwd_blocked``, the emulation of its schedule)."""
    from s2v_torch.kernels.banded_attention_bwd import (
        banded_flash_attention_bwd,
        banded_flash_attention_bwd_blocked,
        banded_flash_attention_bwd_reference,
    )

    got = banded_flash_attention_bwd(q, k, v, o, lse, do, *band)
    want = banded_flash_attention_bwd_reference(q, k, v, o, lse, do, *band)
    what = f"banded_flash_attention_bwd {tuple(q.shape)} band {band}"
    stats = {name: _agreement(a, r, f"{what} {name}") for name, a, r in zip(("dq", "dk", "dv"), got, want)}
    if schedule:
        emulated = banded_flash_attention_bwd_blocked(q, k, v, o, lse, do, *band)
        for name, a, e in zip(("dq", "dk", "dv"), got, emulated):
            stats[name].update(_schedule_stats(a, e, f"{what} {name}"))
    return stats


def _determinism(fn, args, what):
    """Two launches on the same inputs must give the same gradients bit for
    bit (every output has one writer); raises otherwise."""
    import torch

    first, second = fn(*args), fn(*args)
    same = {name: bool(torch.equal(a, c)) for name, a, c in zip(("dq", "dk", "dv"), first, second)}
    if not all(same.values()):
        raise AssertionError(f"{what}: two launches on the same inputs differ: {same}")
    return same


def _banded_bwd_parts_ms(launch, workspace_rows, q):
    """A banded backward's time split among its three kernels (pre-pass, dq,
    dk/dv), each launched alone on a workspace that a whole launch has
    filled; ``launch(workspace, parts)`` launches the parts."""
    from s2v_torch.kernels import banded_attention_bwd as bab

    ws = bab.banded_bwd_workspace(q, workspace_rows)
    launch(ws, bab.ALL_PARTS)
    out = {}
    for name, part in (("prepass", bab.PART_PREPASS), ("dq", bab.PART_DQ), ("dkv", bab.PART_DKV)):
        launch(ws, part)  # warm-up
        out[name] = cuda_ms(lambda: launch(ws, part), 10)
    return out


def phase_kernel_banded_bwd(dev):
    """Kernel B5 (with the global queries' B2 call) against its plain
    version: small geometries, then the training shape, timed beside its
    bound, the plain version and the backward of one masked SDPA call over
    the video queries (a yardstick only)."""
    import torch
    import torch.nn.functional as F

    from s2v_torch.kernels import banded_attention_bwd as bab
    from s2v_torch.kernels.banded_attention import band_geometry
    from s2v_torch.kernels.banded_attention_bwd import (
        banded_flash_attention_bwd,
        banded_flash_attention_bwd_reference,
        launch_banded_bwd,
    )

    small = []
    for (b, h, g, tpf, f, w) in BANDED_SMALL:
        inputs = _banded_bwd_inputs(b, h, g + f * tpf, (g, tpf, w), g + tpf + f, dev)
        small.append({"b": b, "h": h, "band": [g, tpf, f, w],
                      **_compare_banded_bwd(*inputs, (g, tpf, w), schedule=True)})
    emit({"phase": "kernel_banded_bwd_small", "cases": small})

    b, s, h, d = TRAIN_SHAPE
    geo = band_geometry(s, *BAND)
    q, k, v, o, lse, do = _banded_bwd_inputs(b, h, s, BAND, 11, dev, layer_norm=True)
    stats = _compare_banded_bwd(q, k, v, o, lse, do, BAND)
    deterministic = _determinism(banded_flash_attention_bwd, (q, k, v, o, lse, do, *BAND), "banded_flash_attention_bwd")
    banded_flash_attention_bwd(q, k, v, o, lse, do, *BAND)  # warm-up
    ms = cuda_ms(lambda: banded_flash_attention_bwd(q, k, v, o, lse, do, *BAND), 10)
    grads = [torch.empty_like(q) for _ in range(3)]
    rows = geo.n_frames * geo.tokens_per_frame
    ws = bab.banded_bwd_workspace(q, rows)
    video_ms = cuda_ms(lambda: launch_banded_bwd(q, k, v, o, do, lse, *grads, geo, d ** -0.5, ws), 10)
    parts_ms = _banded_bwd_parts_ms(
        lambda ws_, parts: launch_banded_bwd(q, k, v, o, do, lse, *grads, geo, d ** -0.5, ws_, parts), rows, q)
    plain_ms = cuda_ms(lambda: banded_flash_attention_bwd_reference(q, k, v, o, lse, do, *BAND), 2)
    del grads, ws

    def masked_sdpa_bwd(shape):
        qt, kt, vt, mask = _masked_sdpa_args(*shape, geo, 11, dev, requires_grad=True)
        out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
        gt = do[:, geo.global_len:, :shape[1]].transpose(1, 2)
        return lambda: torch.autograd.grad(out, (qt, kt, vt), gt, retain_graph=True)

    library_ms, library_shape, library_failed = _library_ms(
        "masked SDPA backward over the video queries", masked_sdpa_bwd, [(b, h), (b, h // 2)])
    pairs_vid, pairs_glob = geo.pairs()
    flops_vid, flops_glob = 10 * b * h * d * pairs_vid, 10 * b * h * d * pairs_glob
    # q, k, v, o, dO read and dq, dk, dv written once in bf16, plus the fp32 lse
    bound_ms, bound_by = _bound(flops_vid + flops_glob, 8 * b * s * h * d * 2 + b * h * s * 4)
    s_vid = s - geo.global_len
    video_bound_ms, _ = _bound(flops_vid, (3 * s_vid + 4 * s) * b * h * d * 2 + 2 * b * h * s_vid * 4)
    result = {"phase": "kernel_banded_bwd_main", "shape": list(TRAIN_SHAPE), "band": list(BAND), "grads": stats,
              "ms": ms, "video_launch_ms": video_ms, "plain_ms": plain_ms, "library_ms": library_ms,
              "library_shape": library_shape, "library_not_run": library_failed, "bound_ms": bound_ms,
              "bound_by": bound_by, "video_bound_ms": video_bound_ms,
              "global_bound_ms": flops_glob / PEAK_BF16_FLOPS * 1e3, "video_tflops": flops_vid / video_ms / 1e9,
              "video_parts_ms": parts_ms, "deterministic": deterministic,
              "small_worst_schedule_share": max(c[n]["schedule_max_abs_err"] / c[n]["schedule_max_abs_tol"]
                                                for c in small for n in ("dq", "dk", "dv")),
              "smem_bytes": bab._library().s2v_banded_attention_bwd_smem_bytes()}
    emit(result)
    return result


SP_RINGS = (1, 2, 4)  # the seq rings whose shards the SP kernel phases launch, every offset of each


def _agreement_or_zero(o, o_ref, what):
    """:func:`_agreement`, except that an all-zero reference (a dk/dv partial
    of a shard that no query of the band reaches) needs an all-zero output."""
    if not o_ref.any():
        err = o.float().abs().max().item()
        if err != 0.0:
            raise AssertionError(f"{what}: reference is zero, kernel max |x| {err}")
        return {"max_abs_err": 0.0, "max_abs_tol": 0.0, "rel_l2": 0.0, "rel_l2_tol": OUT_L2_REL, "ref_max": 0.0,
                "ref_rms": 0.0}
    return _agreement(o, o_ref, what)


def _shard_rows(x, geo, f_loc, off):
    """A shard's video rows of ``x``: frames ``off .. off + f_loc - 1``, zero
    past the clip, as the SP wrapper takes them."""
    from s2v_torch.parallel.sp_attention import shard_rows

    return shard_rows(x, geo.shard(off, f_loc))


def _compact(stats):
    """The numbers of a small case, for a short JSON line."""
    keys = ("max_abs_err", "max_abs_tol", "rel_l2", "lse_err")
    return {k: stats[k] for k in keys if k in stats}


def phase_kernel_banded_local(dev):
    """Kernel B6 (one SP shard of video-query frames at a runtime frame
    offset, against the full K/V) against its plain version: the small
    geometries at every offset of a 2- and a 4-rank ring, dummy frames
    included (a ring with more ranks than frames is refused before the
    launch, and that is checked); then the main band (B=2) for P = 1, 2, 4:
    the shards' rows stitched against B4's output and lse.  Timed at P = 1
    and per shard at P = 4, each beside its bound, the plain version and one
    masked SDPA call over the shard's video queries (a yardstick only)."""
    import torch
    import torch.nn.functional as F

    from s2v_torch.kernels.banded_attention import (
        band_geometry,
        band_mask,
        banded_flash_attention,
        banded_flash_attention_blocked,
        banded_flash_attention_local,
        banded_flash_attention_local_reference,
        ring_shards,
    )

    def compare(q_loc, k, v, geo, off, schedule=False):
        band = (geo.global_len, geo.tokens_per_frame, geo.window)
        o, lse = banded_flash_attention_local(q_loc, k, v, *band, off, geo.n_frames, return_lse=True)
        o_ref, lse_ref = banded_flash_attention_local_reference(q_loc, k, v, *band, off, geo.n_frames,
                                                                return_lse=True)
        what = f"banded_flash_attention_local {tuple(q_loc.shape)} band {band} offset {off}"
        stats = _agreement(o, o_ref, what)
        lse_err = (lse - lse_ref).abs().max().item()
        if not lse_err < LSE_TOL:
            raise AssertionError(f"{what}: lse max_abs_err {lse_err} (tol {LSE_TOL})")
        stats = {**stats, "lse_err": lse_err}
        if schedule:
            o_emu, lse_emu = banded_flash_attention_blocked(q_loc, k, v, *band, return_lse=True, frame_offset=off,
                                                            n_frames_total=geo.n_frames)
            stats.update(_schedule_stats(o, o_emu, what), schedule_lse_err=(lse - lse_emu).abs().max().item())
            if not stats["schedule_lse_err"] < LSE_TOL:
                raise AssertionError(f"{what}: lse against the emulation {stats['schedule_lse_err']}")
        return stats, o, lse

    small, refused = [], []
    for (b, h, g, tpf, f, w) in BANDED_SMALL:
        geo = band_geometry(g + f * tpf, g, tpf, w)
        q, k, v = _qkv(b, g + f * tpf, g + f * tpf, h, g + tpf + f + 3, dev)
        for ring in (2, 4):
            f_pad, f_loc = ring_shards(f, ring)
            if ring > f:
                try:
                    banded_flash_attention_local(_shard_rows(q, geo, f_loc, (ring - 1) * f_loc), k, v, g, tpf, w,
                                                 (ring - 1) * f_loc, f)
                except ValueError:
                    refused.append([g, tpf, f, w, ring])
                    continue
                raise AssertionError(f"a {ring}-rank ring over {f} frames was not refused")
            for r in range(ring):
                stats, _, _ = compare(_shard_rows(q, geo, f_loc, r * f_loc), k, v, geo, r * f_loc, schedule=True)
                small.append({"band": [b, h, g, tpf, f, w], "ring": ring, "offset": r * f_loc,
                              "dummy_frames": f_loc - geo.shard(r * f_loc, f_loc).real_frames(), **_compact(stats),
                              "schedule_share": stats["schedule_max_abs_err"] / stats["schedule_max_abs_tol"]})
    emit({"phase": "kernel_banded_local_small", "cases": small, "refused_rings": refused})

    b, s, h, d = MAIN_SHAPE
    q, k, v = _ln_qkv(b, s, h, 7, dev)
    geo = band_geometry(s, *BAND)
    g_len, tpf, n_frames = geo.global_len, geo.tokens_per_frame, geo.n_frames
    o4, lse4 = banded_flash_attention(q, k, v, *BAND, return_lse=True)
    stitched, per_shard = {}, {}
    for ring in SP_RINGS:
        _, f_loc = ring_shards(n_frames, ring)
        outs, lses = [], []
        for r in range(ring):
            q_loc = _shard_rows(q, geo, f_loc, r * f_loc)
            if ring == 1:  # the shape the main path gives it: held against the plain version
                stats, o_r, lse_r = compare(q_loc, k, v, geo, 0)
                stitched["plain"] = stats
            else:
                o_r, lse_r = banded_flash_attention_local(q_loc, k, v, *BAND, r * f_loc, n_frames, return_lse=True)
            outs.append(o_r)
            lses.append(lse_r)
        o_cat = torch.cat(outs, dim=1)[:, :n_frames * tpf]
        lse_cat = torch.cat(lses, dim=-1)[..., :n_frames * tpf]
        stats = _agreement(o_cat, o4[:, g_len:], f"B6 shards of a {ring}-rank ring against B4")
        lse_err = (lse_cat - lse4[..., g_len:]).abs().max().item()
        if not lse_err < LSE_TOL:
            raise AssertionError(f"B6 shards of a {ring}-rank ring: lse max_abs_err {lse_err} against B4")
        stitched[f"ring{ring}"] = {**_compact(stats), "lse_err": lse_err,
                                   "bitwise_equal_to_b4": bool(torch.equal(o_cat, o4[:, g_len:]))}
        del outs, lses, o_cat, lse_cat

    def timed(ring, r):
        """ms, plain_ms, bound and the masked-SDPA yardstick of one shard (inference call, no lse)."""
        _, f_loc = ring_shards(n_frames, ring)
        off = r * f_loc
        shard = geo.shard(off, f_loc)
        q_loc = _shard_rows(q, geo, f_loc, off)
        banded_flash_attention_local(q_loc, k, v, *BAND, off, n_frames)  # warm-up
        ms = cuda_ms(lambda: banded_flash_attention_local(q_loc, k, v, *BAND, off, n_frames), 10)
        plain_ms = cuda_ms(lambda: banded_flash_attention_local_reference(q_loc, k, v, *BAND, off, n_frames),
                           2 if ring == 1 else 1)
        sq = q_loc.shape[1]
        # q (the shard's rows), k, v read once and o written once in bf16
        bound_ms, bound_by = _bound(4 * b * h * d * shard.shard_pairs(), (2 * sq + 2 * s) * b * h * d * 2)

        def masked_sdpa(shape):
            bb, hh = shape
            rows = torch.arange(g_len + off * tpf, g_len + (off + f_loc) * tpf, device=dev)
            qt = q_loc[:bb, :, :hh].transpose(1, 2)
            kt, vt = k[:bb, :, :hh].transpose(1, 2), v[:bb, :, :hh].transpose(1, 2)
            mask = band_mask(geo, rows, s)
            return lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)

        library_ms, library_shape, library_failed = _library_ms(
            "masked SDPA over the shard's video queries", masked_sdpa, [(b, h), (1, h), (1, h // 2)])
        return {"ring": ring, "rank": r, "offset": off, "local_frames": f_loc,
                "dummy_frames": f_loc - shard.real_frames(), "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": library_ms, "library_shape": library_shape,
                "library_not_run": library_failed, "tflops": 4 * b * h * d * shard.shard_pairs() / ms / 1e9}

    per_shard["ring1"] = timed(1, 0)
    per_shard["ring4"] = [timed(4, r) for r in range(4)]
    result = {"phase": "kernel_banded_local_main", "shape": list(MAIN_SHAPE), "band": list(BAND),
              "q_shape_ring1": [b, n_frames * tpf, h, d], "stitched": stitched, "timed": per_shard,
              # the worst small case, as a share of its limit (against the plain version, the emulation)
              "small_worst_err_share": max(c["max_abs_err"] / c["max_abs_tol"] for c in small),
              "small_worst_schedule_share": max(c["schedule_share"] for c in small)}
    emit(result)
    return result


def phase_kernel_banded_local_bwd(dev):
    """Kernel B7 (the backward of B6 for one shard: its dq, and the
    full-extent dk/dv partials from its queries) against its plain version:
    the small geometries at every offset of a 2- and a 4-rank ring; then the
    training band (B=1) for P = 1, 2, 4: dq stitched over the shards against
    B5's video dq, the dk/dv partials summed over the shards plus the global
    queries' B2 part against B5's dk/dv; dummy frames holding junk change
    nothing.  Timed at P = 1 and per shard at P = 4 beside its bound, the
    plain version and the backward of one masked SDPA call over the shard's
    video queries (a yardstick only)."""
    import torch
    import torch.nn.functional as F

    from s2v_torch.kernels.banded_attention import (
        band_geometry,
        band_mask,
        banded_flash_attention_local,
        ring_shards,
    )
    from s2v_torch.kernels.banded_attention_bwd import (
        banded_flash_attention_bwd,
        banded_flash_attention_bwd_blocked,
        banded_flash_attention_local_bwd,
        banded_flash_attention_local_bwd_reference,
        launch_banded_local_bwd,
    )
    from s2v_torch.kernels.flash_attention_bwd import flash_attention_bwd

    def shard_inputs(q, k, v, do, geo, f_loc, off):
        band = (geo.global_len, geo.tokens_per_frame, geo.window)
        q_loc, do_loc = _shard_rows(q, geo, f_loc, off), _shard_rows(do, geo, f_loc, off)
        o, lse = banded_flash_attention_local(q_loc, k, v, *band, off, geo.n_frames, return_lse=True)
        return q_loc, k, v, o, lse, do_loc, *band, off, geo.n_frames

    def compare(args, schedule=False):
        got = banded_flash_attention_local_bwd(*args)
        want = banded_flash_attention_local_bwd_reference(*args)
        what = f"banded_flash_attention_local_bwd {tuple(args[0].shape)} offset {args[9]}"
        stats = {n: _agreement_or_zero(a, r, f"{what} {n}") for n, a, r in zip(("dq", "dk", "dv"), got, want)}
        if schedule:
            emulated = banded_flash_attention_bwd_blocked(*args[:9], frame_offset=args[9], n_frames_total=args[10])
            for n, a, e in zip(("dq", "dk", "dv"), got, emulated):
                st = _agreement_or_zero(a, e, f"{what} {n} against the emulation of its schedule")
                stats[n]["schedule_share"] = st["max_abs_err"] / st["max_abs_tol"] if st["max_abs_tol"] else 0.0
        return got, stats

    small = []
    for (b, h, g, tpf, f, w) in BANDED_SMALL:
        geo = band_geometry(g + f * tpf, g, tpf, w)
        q, k, v = _qkv(b, g + f * tpf, g + f * tpf, h, g + tpf + f + 5, dev)
        do = torch.randn(q.shape, device=dev, generator=torch.Generator(device=dev).manual_seed(f)).to(q.dtype)
        for ring in (2, 4):
            _, f_loc = ring_shards(f, ring)
            if ring > f:
                continue  # refused before the launch (kernel_banded_local checks it)
            for r in range(ring):
                _, stats = compare(shard_inputs(q, k, v, do, geo, f_loc, r * f_loc), schedule=True)
                small.append({"band": [b, h, g, tpf, f, w], "ring": ring, "offset": r * f_loc,
                              **{n: {**_compact(st), "schedule_share": st["schedule_share"]}
                                 for n, st in stats.items()}})
    emit({"phase": "kernel_banded_local_bwd_small", "cases": small})

    b, s, h, d = TRAIN_SHAPE
    geo = band_geometry(s, *BAND)
    g_len, tpf, n_frames = geo.global_len, geo.tokens_per_frame, geo.n_frames
    q, k, v, o, lse, do = _banded_bwd_inputs(b, h, s, BAND, 11, dev, layer_norm=True)
    dq5, dk5, dv5 = banded_flash_attention_bwd(q, k, v, o, lse, do, *BAND)
    # the global queries' share of dk/dv (B2), as the SP wrapper adds it
    _, dk_g, dv_g = flash_attention_bwd(q[:, :g_len], k, v, o[:, :g_len], lse[..., :g_len].contiguous(),
                                        do[:, :g_len])
    stitched = {}
    for ring in SP_RINGS:
        _, f_loc = ring_shards(n_frames, ring)
        dqs, dk, dv = [], dk_g.float(), dv_g.float()
        for r in range(ring):
            args = shard_inputs(q, k, v, do, geo, f_loc, r * f_loc)
            if ring == 1:
                (dq_r, dk_r, dv_r), stats = compare(args)
                stitched["plain"] = {n: _compact(st) for n, st in stats.items()}
            else:
                dq_r, dk_r, dv_r = banded_flash_attention_local_bwd(*args)
            dqs.append(dq_r)
            dk, dv = dk + dk_r.float(), dv + dv_r.float()
        dq_cat = torch.cat(dqs, dim=1)[:, :n_frames * tpf]
        what = f"B7 over a {ring}-rank ring against B5"
        stitched[f"ring{ring}"] = {
            "dq": _compact(_agreement(dq_cat, dq5[:, g_len:], f"{what} dq")),
            "dk": _compact(_agreement(dk, dk5, f"{what} dk")),
            "dv": _compact(_agreement(dv, dv5, f"{what} dv")),
            "dq_bitwise_equal_to_b5": bool(torch.equal(dq_cat, dq5[:, g_len:]))}
        del dqs, dk, dv, dq_cat

    # dummy frames (the last rank of a 4-rank ring holds 1 real frame and 3
    # dummies): junk in their q and dO rows leaves every real gradient as it was
    _, f_loc = ring_shards(n_frames, 4)
    off = 3 * f_loc
    args = list(shard_inputs(q, k, v, do, geo, f_loc, off))
    real = geo.shard(off, f_loc).real_frames() * tpf
    clean = banded_flash_attention_local_bwd(*args)
    junk = torch.randn(args[0].shape, device=dev, generator=torch.Generator(device=dev).manual_seed(5)).to(q.dtype)
    for i in (0, 5):  # q, dO
        args[i] = args[i].clone()
        args[i][:, real:] = junk[:, real:]
    dirty = banded_flash_attention_local_bwd(*args)
    dummy = {"offset": off, "dummy_rows": f_loc * tpf - real,
             "dq_real_rows_equal": bool(torch.equal(clean[0][:, :real], dirty[0][:, :real])),
             "dq_dummy_rows_zero": not bool(dirty[0][:, real:].any()),
             "dk_equal": bool(torch.equal(clean[1], dirty[1])), "dv_equal": bool(torch.equal(clean[2], dirty[2]))}
    if not all(v for key, v in dummy.items() if key not in ("offset", "dummy_rows")):
        raise AssertionError(f"B7: dummy frames contributed {dummy}")
    del clean, dirty, junk, args

    # at one rank (the main path's shape): two launches agree bit for bit;
    # the time split among the three kernels
    args = shard_inputs(q, k, v, do, geo, n_frames, 0)
    deterministic = _determinism(banded_flash_attention_local_bwd, args, "banded_flash_attention_local_bwd")
    one = geo.shard(0, n_frames)
    grads = [torch.empty_like(args[0]), torch.empty_like(k), torch.empty_like(v)]
    parts_ms = _banded_bwd_parts_ms(
        lambda ws, parts: launch_banded_local_bwd(args[0], k, v, args[3], args[5], args[4], *grads, one, d ** -0.5,
                                                  ws, parts), n_frames * tpf, args[0])
    del args, grads

    def timed(ring, r):
        _, f_loc = ring_shards(n_frames, ring)
        off = r * f_loc
        shard = geo.shard(off, f_loc)
        args = shard_inputs(q, k, v, do, geo, f_loc, off)
        banded_flash_attention_local_bwd(*args)  # warm-up
        ms = cuda_ms(lambda: banded_flash_attention_local_bwd(*args), 10)
        plain_ms = cuda_ms(lambda: banded_flash_attention_local_bwd_reference(*args), 2 if ring == 1 else 1)
        sq = args[0].shape[1]
        # q, o, dO read and dq written at the shard's rows, k, v read and dk, dv
        # written at every row, in bf16; the fp32 lse read
        bound_ms, bound_by = _bound(10 * b * h * d * shard.shard_pairs(),
                                    (4 * sq + 4 * s) * b * h * d * 2 + b * h * sq * 4)

        def masked_sdpa_bwd(shape):
            bb, hh = shape
            rows = torch.arange(g_len + off * tpf, g_len + (off + f_loc) * tpf, device=dev)
            qt, kt, vt = (x[:bb, :, :hh].transpose(1, 2).detach().requires_grad_() for x in (args[0], k, v))
            out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=band_mask(geo, rows, s))
            gt = args[5][:bb, :, :hh].transpose(1, 2)
            return lambda: torch.autograd.grad(out, (qt, kt, vt), gt, retain_graph=True)

        library_ms, library_shape, library_failed = _library_ms(
            "masked SDPA backward over the shard's video queries", masked_sdpa_bwd, [(b, h), (b, h // 2)])
        return {"ring": ring, "rank": r, "offset": off, "local_frames": f_loc,
                "dummy_frames": f_loc - shard.real_frames(), "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": library_ms, "library_shape": library_shape,
                "library_not_run": library_failed, "tflops": 10 * b * h * d * shard.shard_pairs() / ms / 1e9}

    per_shard = {"ring1": timed(1, 0), "ring4": [timed(4, r) for r in range(4)]}
    result = {"phase": "kernel_banded_local_bwd_main", "shape": list(TRAIN_SHAPE), "band": list(BAND),
              "stitched": stitched, "dummy_frames": dummy, "timed": per_shard, "deterministic": deterministic,
              "parts_ms_ring1": parts_ms,
              "small_worst_schedule_share": max(c[n]["schedule_share"] for c in small for n in ("dq", "dk", "dv")),
              # the worst small case (an all-zero partial has limit 0 and is held to exact zero)
              "small_worst_err_share": max(st["max_abs_err"] / st["max_abs_tol"] for c in small
                                           for n, st in c.items() if n in ("dq", "dk", "dv") and st["max_abs_tol"])}
    emit(result)
    return result


def _prepass_equal(q, k, what):
    """B3's pre-pass kernels against ``int8_prepass`` on the same CUDA
    tensors: q_i8, k_i8 and dq equal bit for bit, or raise."""
    import torch

    from s2v_torch.kernels.int8_attention import int8_prepass, launch_int8_prepass

    scale = q.shape[-1] ** -0.5
    got, want = launch_int8_prepass(q, k, scale), int8_prepass(q, k, scale)
    same = {name: bool(torch.equal(a, b)) for name, a, b in zip(("q_i8", "k_i8", "dq"), got, want)}
    if not all(same.values()):
        raise AssertionError(f"{what}: the pre-pass kernels differ from int8_prepass: {same}")
    return True


def _compare_int8(q, k, v, schedule=False):
    """B3 against its plain version (and, on the small cases, against
    ``flash_attention_qk_int8_blocked``, the emulation of its schedule), and
    its pre-pass kernels against ``int8_prepass`` bit for bit."""
    from s2v_torch.kernels.int8_attention import (
        flash_attention_qk_int8,
        flash_attention_qk_int8_blocked,
        flash_attention_qk_int8_reference,
    )

    what = f"flash_attention_qk_int8 {tuple(q.shape)}x{tuple(k.shape)}"
    o = flash_attention_qk_int8(q, k, v)
    stats = _agreement(o, flash_attention_qk_int8_reference(q, k, v), what)
    if schedule:
        stats.update(_schedule_stats(o, flash_attention_qk_int8_blocked(q, k, v), what))
    return {**stats, "prepass_bit_equal": _prepass_equal(q, k, what)}


def _wgmma_s8_tile(dev):
    """One s8 ``wgmma`` tile through B3's 64-byte-swizzle TMA maps and
    descriptors against an integer matmul, equal or raise."""
    import torch

    from s2v_torch.kernels.int8_attention import int8_qk_tile

    g = torch.Generator(device=dev).manual_seed(11)
    q = torch.randint(-127, 128, (64, 64), generator=g, device=dev, dtype=torch.int8)
    k = torch.randint(-127, 128, (128, 64), generator=g, device=dev, dtype=torch.int8)
    q[0], k[0] = 127, -127  # the extremes
    got = int8_qk_tile(q, k).cpu().long()
    want = q.cpu().long() @ k.cpu().long().T
    if not torch.equal(got, want):
        bad = (got != want).nonzero()
        raise AssertionError(f"s8 wgmma tile: {bad.shape[0]} of 8192 entries differ, first at {bad[:4].tolist()}")
    return {"entries": got.numel(), "equal": True, "max_abs": int(want.abs().max())}


def _sfu_exp_ms(n_exp):
    """``n_exp`` exponentials over the SFUs' rate: SMs x 16 ex2 a clock x the
    card's maximum SM clock (nvidia-smi); the time and what it used."""
    import torch

    mhz = float(subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                               capture_output=True, text=True, check=True).stdout.strip())
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return n_exp / (sms * SFU_EX2_PER_CLOCK * mhz * 1e6) * 1e3, {"sms": sms, "max_sm_clock_mhz": mhz}


def phase_kernel_int8(dev):
    """Kernel B3 against its plain version (the same pre-pass; integer-exact
    logits in both, so what differs is exp2 and the bf16 rounding of P and
    of the output: B1's limits) and, on the small cases, against the
    emulation of its schedule; its pre-pass kernels against
    ``int8_prepass`` bit for bit everywhere; one s8 ``wgmma`` tile against
    an integer matmul first.  Small ragged shapes, negative-logit rows with
    a ragged key tail, a batch whose halves differ in magnitude, then the
    main shape: two launches equal bit for bit, and the pre-pass kernels,
    the main launch and the whole function timed beside the torch
    pre-pass, the bound (tensor cores, exponentials on the SFUs, bytes),
    the plain version and B1 online at the same shape."""
    import torch

    from s2v_torch.kernels.flash_attention import flash_attention
    from s2v_torch.kernels.int8_attention import (
        flash_attention_qk_int8,
        flash_attention_qk_int8_reference,
        int8_prepass,
        kernel_smem_bytes,
        launch_int8,
        launch_int8_prepass,
    )

    tile = _wgmma_s8_tile(dev)
    small = []
    # ragged against the 128-row query blocks and 128-key tiles (54 = 19,126 mod 128), Sq != Skv both ways,
    # a single key tile
    for (b, sq, skv, h) in [(2, 90, 90, 2), (1, 200, 77, 3), (2, 77, 333, 2), (2, 1000, 129, 2), (1, 310, 438, 2)]:
        q, k, v = _qkv(b, sq, skv, h, sq + skv + 1, dev)
        small.append({"q": [b, sq, h, 64], "skv": skv, **_compare_int8(q, k, v, schedule=True)})
    # every real scaled logit about -128, 90 keys in one ragged tile: a
    # zero-filled pad key taken as logit 0 would pin the max and zero the row
    g = torch.Generator(device=dev).manual_seed(5)
    q = torch.full((1, 90, 1, 64), 4.0, device=dev, dtype=torch.bfloat16)
    k = (-4.0 + 0.01 * torch.randn(1, 90, 1, 64, device=dev, generator=g)).to(torch.bfloat16)
    v = torch.randn(1, 90, 1, 64, device=dev, generator=g).to(torch.bfloat16)
    negative = _compare_int8(q, k, v, schedule=True)
    if not negative["ref_max"] > 0.01:
        raise AssertionError(f"negative-logit rows: the plain version's output is zero {negative}")
    # uncond/cond halves of different magnitudes share one scale
    q, k, v = _qkv(2, 300, 300, 2, 9, dev)
    q[1] *= 3.0
    k[1] *= 0.25
    halves = _compare_int8(q, k, v, schedule=True)
    emit({"phase": "kernel_int8_small", "wgmma_s8_tile": tile, "cases": small, "negative_logits": negative,
          "halves": halves})

    b, s, h, d = MAIN_SHAPE
    q, k, v = _ln_qkv(b, s, h, 7, dev)
    stats = _compare_int8(q, k, v)
    first, second = flash_attention_qk_int8(q, k, v), flash_attention_qk_int8(q, k, v)
    if not torch.equal(first, second):
        raise AssertionError("flash_attention_qk_int8: two launches on the same inputs differ")
    del first, second
    flash_attention_qk_int8(q, k, v)  # warm-up
    ms = cuda_ms(lambda: flash_attention_qk_int8(q, k, v), 10)
    prepass_ms = cuda_ms(lambda: launch_int8_prepass(q, k, d ** -0.5), 10)
    torch_prepass_ms = cuda_ms(lambda: int8_prepass(q, k, d ** -0.5), 10)
    q_i8, k_i8, dq = launch_int8_prepass(q, k, d ** -0.5)
    o = torch.empty_like(q)
    launch_ms = cuda_ms(lambda: launch_int8(q_i8, k_i8, v, o, dq), 10)
    del q_i8, k_i8, o
    plain_ms = cuda_ms(lambda: flash_attention_qk_int8_reference(q, k, v), 2)
    flash_attention(q, k, v, softmax_mode="online")  # warm-up
    b1_online_ms = cuda_ms(lambda: flash_attention(q, k, v, softmax_mode="online"), 10)
    products = 2 * b * h * s * s * d  # each of q·kᵀ (int8) and P·V (bf16)
    tensor_ms = (products / PEAK_INT8_OPS + products / PEAK_BF16_FLOPS) * 1e3
    exp_ms, sfu = _sfu_exp_ms(b * h * s * s)
    # q, k, v read once and o written once in bf16
    bytes_ms = 4 * b * s * h * d * 2 / PEAK_BYTES_PER_S * 1e3
    bound_ms, set_by = max((tensor_ms, "tensor cores"), (exp_ms, "exponentials (SFU)"), (bytes_ms, "bytes"))
    # the pre-pass: q and k read once in bf16, q_i8 and k_i8 written once
    prepass_bound_ms = 6 * b * s * h * d / PEAK_BYTES_PER_S * 1e3
    result = {"phase": "kernel_int8_main", "shape": list(MAIN_SHAPE), **stats, "deterministic": True,
              "ms": ms, "launch_ms": launch_ms, "prepass_ms": prepass_ms, "torch_prepass_ms": torch_prepass_ms,
              "prepass_bound_ms": prepass_bound_ms, "plain_ms": plain_ms, "library_ms": None,
              "b1_online_ms": b1_online_ms, "bound_ms": bound_ms,
              "bound_by": "bytes" if set_by == "bytes" else "operations", "bound_set_by": set_by,
              "bound_parts_ms": {"tensor_cores": tensor_ms, "exponentials": exp_ms, "bytes": bytes_ms, **sfu},
              "launch_tops": 2 * products / launch_ms / 1e9, "launch_bound_share": bound_ms / launch_ms,
              "bound_share": bound_ms / ms, "smem_bytes": kernel_smem_bytes()}
    emit(result)
    return {**result, "small_worst_schedule_share": max(
        c["schedule_max_abs_err"] / c["schedule_max_abs_tol"] for c in [*small, negative, halves])}


def phase_reference(dev):
    """A small bf16 pipeline with d=64 heads: the flash kernel path against
    the plain fp32 attention path, on the same weights, inputs and noise;
    the windowed backend (B4, w = 1, 5 latent frames of 16 tokens) against
    the gather path on the plain attention; and the int8 tree with
    ``flash_int8`` (B3) against the plain attention on the same int8 tree.
    The int8 clip's relative RMS against the bf16 flash clip is printed
    (the JAX package's test holds a DiT output to 0.10)."""
    import torch

    from s2v_torch import S2VPipeline, TransformerConfig, VAEConfig
    from s2v_torch.models.transformer import init_transformer_params_random
    from s2v_torch.models.vae import init_vae_params_random
    from s2v_torch.ops.quant import quantize_transformer_params

    tcfg = TransformerConfig.tiny(num_attention_heads=2, attention_head_dim=64, dtype=torch.bfloat16)
    vcfg = VAEConfig.tiny(latent_channels=4, sample_height=64, sample_width=64, dtype=torch.bfloat16)
    pipe = S2VPipeline(init_transformer_params_random(tcfg, seed=3, device=dev, scale=0.1), tcfg,
                       init_vae_params_random(vcfg, seed=4, device=dev), vcfg, device=dev)
    g = np.random.RandomState(0)
    embeds = torch.from_numpy(g.randn(2, 16, 32).astype(np.float32))
    bf16_params = pipe.transformer_params
    int8_params = quantize_transformer_params(bf16_params)
    result = {"phase": "reference", "rel_tol": PIPELINE_REL_TOL}
    for name, size, frames, (kernel, plain) in [("flash", 32, 9, ("flash", "plain")),
                                                ("windowed", 64, 17, ("windowed", "windowed_plain")),
                                                ("int8", 32, 9, ("flash_int8", "plain"))]:
        pipe.transformer_params = int8_params if name == "int8" else bf16_params
        kw = dict(prompt_embeds=embeds, ref_image=np.clip(g.randn(size, size, 3) * 0.5, -1, 1), height=size,
                  width=size, num_frames=frames, num_inference_steps=2, guidance_scale=2.0, output_type="latent",
                  seed=1)
        pipe.set_attention(kernel, 1)
        got = pipe.generate(**kw).float()
        pipe.set_attention(plain, 1)
        want = pipe.generate(**kw).float()
        err = (got - want).abs().max().item()
        rel = err / want.abs().max().item()
        if not (torch.isfinite(got).all() and rel < PIPELINE_REL_TOL):
            raise AssertionError(f"small pipeline: {kernel} vs {plain} max_abs_err {err}, relative {rel} "
                                 f"(tol {PIPELINE_REL_TOL})")
        result[name] = {"max_abs_err": err, "relative_err": rel, "shape": list(got.shape)}
    # the last case's int8 clip against the bf16 tree's flash clip on the
    # same inputs: a finding, not a gate
    pipe.transformer_params = bf16_params
    pipe.set_attention("flash", 1)
    bf16 = pipe.generate(**kw).float()
    result["int8"]["rel_rms_vs_bf16"] = ((got - bf16).square().mean().sqrt() / bf16.square().mean().sqrt()).item()
    emit(result)


COUNTED = ("flash_attention", "flash_attention_bwd", "banded_flash_attention", "banded_flash_attention_bwd",
           "flash_attention_qk_int8", "banded_flash_attention_local", "banded_flash_attention_local_bwd")


def _counted_fns():
    from s2v_torch.kernels.banded_attention import banded_flash_attention, banded_flash_attention_local
    from s2v_torch.kernels.banded_attention_bwd import banded_flash_attention_bwd, banded_flash_attention_local_bwd
    from s2v_torch.kernels.flash_attention import flash_attention
    from s2v_torch.kernels.flash_attention_bwd import flash_attention_bwd
    from s2v_torch.kernels.int8_attention import flash_attention_qk_int8

    return dict(zip(COUNTED, (flash_attention, flash_attention_bwd, banded_flash_attention,
                              banded_flash_attention_bwd, flash_attention_qk_int8, banded_flash_attention_local,
                              banded_flash_attention_local_bwd)))


def reset_counts():
    """Every kernel's launch count (and B1's online re-runs, B3's pre-pass
    launches) set to 0."""
    fns = _counted_fns()
    for fn in fns.values():
        fn.launches = 0
    fns["flash_attention"].reruns = 0
    fns["flash_attention_qk_int8"].prepass_launches = 0


def read_counts() -> dict:
    fns = _counted_fns()
    return {**{name: fn.launches for name, fn in fns.items()}, "reruns": fns["flash_attention"].reruns,
            "flash_attention_qk_int8_prepass": fns["flash_attention_qk_int8"].prepass_launches}


def check_counts(counts: dict, backend: str, forwards: int, backwards: int) -> bool:
    """The launches of ``forwards`` block forwards and ``backwards`` block
    backwards with ``backend``: one B1 per forward (net of the bounded
    mode's re-runs; the windowed backends' global queries run online, with
    none) and one B2 per backward; the windowed backend adds one B4 per
    forward and one B5 per backward, sp_windowed (one rank) one B6 and one
    B7 instead; the int8 backend runs one B3 (its pre-pass kernels and its
    main kernel) per forward instead of B1."""
    windowed, sp, int8 = backend == "windowed", backend == "sp_windowed", backend == "flash_int8"
    want = {"flash_attention": 0 if int8 else forwards, "flash_attention_bwd": backwards,
            "banded_flash_attention": forwards if windowed else 0,
            "banded_flash_attention_bwd": backwards if windowed else 0,
            "banded_flash_attention_local": forwards if sp else 0,
            "banded_flash_attention_local_bwd": backwards if sp else 0,
            "flash_attention_qk_int8": forwards if int8 else 0,
            "flash_attention_qk_int8_prepass": forwards if int8 else 0}
    got = {**counts, "flash_attention": counts["flash_attention"] - counts["reruns"]}
    return all(got[k] == v for k, v in want.items()) and not ((windowed or sp) and counts["reruns"])


def build_full_pipe(dev):
    """The CogVideoX-5b pipeline at full width (42-block DiT, T5-XXL, the
    full VAE) with random weights from fixed seeds, and a tokenizer over a
    tiny ``spiece.model`` written into ``build/``."""
    import torch

    from s2v_torch import S2VPipeline, T5Config, TransformerConfig, VAEConfig
    from s2v_torch.models.t5 import init_t5_params_random
    from s2v_torch.models.transformer import init_transformer_params_random
    from s2v_torch.models.vae import init_vae_params_random
    from s2v_torch.utils.sp_native import NativeSPTokenizer, write_spiece_model

    t0 = time.perf_counter()
    tcfg, t5cfg, vcfg = TransformerConfig(), T5Config(), VAEConfig()
    spiece = REPO / "build" / "smoke_spiece.model"
    write_spiece_model(spiece, [
        ("<pad>", 0.0, 3), ("</s>", 0.0, 3), ("<unk>", 0.0, 2), ("▁", -4.0, 1), ("▁a", -2.0, 1),
        ("▁pig", -1.0, 1), ("▁walk", -1.5, 1), ("ing", -1.2, 1), ("▁in", -2.0, 1), ("▁the", -2.0, 1),
        ("▁park", -2.0, 1),
    ])
    pipe = S2VPipeline(
        transformer_params=init_transformer_params_random(tcfg, seed=0, device=dev), transformer_cfg=tcfg,
        vae_params=init_vae_params_random(vcfg, seed=2, device=dev), vae_cfg=vcfg,
        t5_params=init_t5_params_random(t5cfg, seed=1, device=dev), t5_cfg=t5cfg,
        tokenizer=NativeSPTokenizer(spiece), device=dev,
    )
    torch.cuda.synchronize()
    emit({"phase": "init", "init_s": time.perf_counter() - t0, "weights_gb": torch.cuda.memory_allocated() / 1e9})
    return pipe


def phase_e2e(dev, pipe, backend="flash", window=2, num_frames=49, name=None, extra=None):
    """``generate`` at 49x480x720, 2 steps, with ``backend`` (and the window
    half-width of a windowed backend), then one more denoise step (a
    1-step ``generate`` to latents) under ``torch.profiler``: its device
    time by kernel family.  The pipeline's backend is restored after.
    ``name`` and ``extra`` name the printed line and add to it."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    tcfg = pipe.transformer_cfg
    image = np.clip(np.random.RandomState(42).randn(480, 720, 3).astype(np.float32) * 0.5, -1, 1)
    kw = dict(prompt="a pig walking in the park", ref_image=image, height=480, width=720, num_frames=num_frames,
              guidance_scale=6.0, seed=42)
    saved = (pipe.attention_backend, pipe.transformer_cfg)
    pipe.set_attention(backend, window)
    torch.cuda.reset_peak_memory_stats()
    try:
        reset_counts()
        t0 = time.perf_counter()
        video = pipe.generate(num_inference_steps=2, **kw)
        wall_s = time.perf_counter() - t0
        counts = read_counts()
        timings = pipe.timings
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            latents = pipe.generate(num_inference_steps=1, output_type="latent", **kw)
        profiled = {"step_s": pipe.timings["denoise_step_s"][0], **device_breakdown(prof)}
    finally:
        pipe.attention_backend, pipe.transformer_cfg = saved

    expected = (1, num_frames, 480, 720, 3)
    if video.shape != expected or not np.isfinite(video).all() or video.min() < 0 or video.max() > 1:
        raise AssertionError(f"generate output {video.shape}, finite {np.isfinite(video).all()}, "
                             f"range [{video.min()}, {video.max()}]")
    if not check_counts(counts, backend, 2 * tcfg.num_layers, 0):
        raise AssertionError(f"{backend} generate launches {counts}; expected {2 * tcfg.num_layers} per "
                             f"forward kernel and no backward")
    emit({"phase": name or ("e2e" if backend == "flash" else f"e2e_{backend}"), "backend": backend, **(extra or {}),
          "window": window if backend in ("windowed", "sp_windowed") else None, "num_frames": num_frames, "steps": 2,
          "output_shape": list(video.shape), "launches": counts,
          "encode_prompt_s": timings["encode_prompt_s"], "encode_ref_s": timings["encode_ref_s"],
          "denoise_step_s": timings["denoise_step_s"], "decode_s": timings["decode_s"], "wall_s": wall_s,
          "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
          "output_mean": float(video.mean()), "output_std": float(video.std()), "profiled_step": profiled})
    # the profiled 1-step generate's latents, for comparing backends on the same seed
    return {**counts, "latents": latents.float().cpu()}


def train_steps(pipe, dev, height, width, num_frames, steps, spec, optimizer_spec, backend):
    """Encode one seeded clip through ``latent_batches``, then run ``steps``
    LoRA train steps on ``pipe``'s DiT with remat.  The launch counts are
    zeroed before and read after each step.  On CUDA one more step runs
    under ``torch.profiler``.  Returns what the phase checks and prints;
    runs on the CPU too (at a tiny size, where no kernel launches)."""
    import torch

    from s2v_torch.training.data import latent_batches
    from s2v_torch.training.lora import (
        export_lora_to_reference_format,
        init_lora_params,
        lora_leaves,
        make_lora_train_step,
    )

    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    rng = np.random.RandomState(7)
    item = {"video": np.clip(rng.randn(num_frames, height, width, 3) * 0.5, -1, 1).astype(np.float32),
            "ref_image": np.clip(rng.randn(height, width, 3) * 0.5, -1, 1).astype(np.float32),
            "prompt": "a pig walking in the park"}
    t0 = time.perf_counter()
    batch = next(latent_batches([item], pipe, batch_size=1, seed=0))
    f_lat = batch["video_latents"].shape[1]
    # the RoPE tables, as the JAX on-chip train probe adds them (the JAX
    # trainer CLI's batches carry none)
    batch["rope_cos"], batch["rope_sin"] = pipe.prepare_rope(height, width, f_lat)
    sync()
    encode_s = time.perf_counter() - t0

    params, cfg = pipe.transformer_params, pipe.transformer_cfg
    base = [t for layer in params["blocks"] for leaf in layer.values() for t in _tensors(leaf)]
    base += [t for k, v in params.items() if k != "blocks" for t in _tensors(v)]
    checksum = lambda: torch.stack([torch.stack([t.float().sum(), t.float().abs().sum()]) for t in base])  # noqa: E731
    before = checksum()

    lora = init_lora_params(torch.Generator(device=dev).manual_seed(1), params, spec)
    init_opt, step = make_lora_train_step(params, cfg, spec, attention_backend=backend, remat=True,
                                          optimizer_spec=optimizer_spec)
    opt_state = init_opt(lora)
    lora_bytes = sum(t.numel() * t.element_size() for t in lora_leaves(lora))
    state_bytes = sum(t.numel() * t.element_size() for k in ("mu", "nu") for t in opt_state[k])
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(3)
    losses, step_s, counts, b_nonzero = [], [], [], []
    for _ in range(steps):
        reset_counts()
        t0 = time.perf_counter()
        lora, opt_state, loss = step(lora, opt_state, batch, gen)
        sync()
        step_s.append(time.perf_counter() - t0)
        counts.append(read_counts())
        losses.append(loss.item())
        b_nonzero.append(any(bool(ab["b"].any()) for ab in lora.values()))
    profiled = None
    if dev.type == "cuda":
        from torch.profiler import ProfilerActivity
        from torch.profiler import profile as torch_profile

        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            lora, opt_state, loss = step(lora, opt_state, batch, gen)
            sync()
            host_s = time.perf_counter() - t0
        profiled = {"host_s": host_s, "loss": loss.item(), **device_breakdown(prof)}
    return {
        "batch_shape": list(batch["video_latents"].shape), "encode_s": encode_s, "losses": losses,
        "step_s": step_s, "launches": counts, "b_nonzero": b_nonzero,
        "base_unchanged": bool(torch.equal(before, checksum())),
        "lora_params": sum(t.numel() for t in lora_leaves(lora)), "lora_bytes": lora_bytes,
        "opt_state_bytes": state_bytes,
        "export_keys": len(export_lora_to_reference_format(lora, spec, cfg)),
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9 if dev.type == "cuda" else None,
        "profiled_step": profiled,
    }


# kernel families of a profiled step, by substrings of the kernel's name
KERNEL_FAMILIES = (
    # B3's kernels share a prefix no library kernel has
    ("flash_attention_qk_int8 pre-pass (B3)", ("s2v_i8attn_amax", "s2v_i8attn_quantize")),
    ("flash_attention_qk_int8 (B3)", ("s2v_i8attn_fwd",)),
    ("int8 matmul (cuBLASLt)", ("gemm_s8", "imma", "s8s8")),
    # B6 and B7 run the same __global__ functions as B4 and B5
    ("banded_flash_attention (B4, B6)", ("banded_fwd_kernel",)),
    ("banded_flash_attention_bwd (B5, B7)", ("banded_bwd_",)),
    ("collectives (NCCL)", ("nccl",)),
    ("flash_attention (B1)", ("flash_fwd_kernel",)),
    ("flash_attention_bwd (B2)", ("flash_bwd_",)),
    ("matmul (cuBLAS)", ("nvjet", "gemm", "xmma", "cutlass", "cublas")),
    ("elementwise and reductions", ("elementwise", "reduce", "norm", "softmax", "copy_kernel", "cat")),
    ("copy", ("Memcpy", "Memset")),
)


def device_breakdown(prof) -> dict:
    """Device time of a ``torch.profiler`` run by kernel family, the device's
    busy time (the union of kernel intervals) and its idle share within the
    span from the first kernel's start to the last one's end."""
    from torch.autograd import DeviceType

    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        raise AssertionError("the profiler recorded no device activity")
    by_family, by_name, spans = {}, {}, []
    for e in kernels:
        us = e.time_range.elapsed_us()
        family = next((f for f, keys in KERNEL_FAMILIES if any(k in e.name for k in keys)), "other")
        by_family[family] = by_family.get(family, 0.0) + us
        by_name[e.name] = by_name.get(e.name, 0.0) + us
        spans.append((e.time_range.start, e.time_range.end))
    spans.sort()
    busy, end = 0.0, spans[0][0]
    for lo, hi in spans:
        if hi > end:
            busy += hi - max(lo, end)
            end = hi
    window = spans[-1][1] - spans[0][0]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    # the collectives' host-side calls (c10d / NCCL ops of the SP wrapper)
    collectives = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA and (e.name.startswith("c10d::") or e.name.startswith("nccl:")):
            calls, us = collectives.get(e.name, (0, 0.0))
            collectives[e.name] = (calls + 1, us + e.time_range.elapsed_us())
    return {"device_ms_by_family": {k: v / 1e3 for k, v in sorted(by_family.items(), key=lambda kv: -kv[1])},
            "busy_ms": busy / 1e3, "window_ms": window / 1e3, "idle_share": 1.0 - busy / window,
            "kernel_launches": len(kernels), "top_kernels_ms": {k[:80]: v / 1e3 for k, v in top},
            "collectives_host": {k: {"calls": c, "ms": us / 1e3} for k, (c, us) in collectives.items()}}


def _tensors(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    return [tree]


def phase_train(dev, pipe, backend="flash", steps=3, name=None, extra=None):
    """Three LoRA train steps of the full-width DiT (rank 128, all seven
    target families, ``backend`` attention both ways, remat) on one
    49x480x720 clip, with the template optimizer (adamw, bf16 first moment,
    clip 1.0), then a fourth under ``torch.profiler``: its device time by
    kernel family and the device's idle share.  ``name`` and ``extra`` name
    the printed line and add to it."""
    from s2v_torch.training.lora import LoRASpec
    from s2v_torch.training.optim import OptimizerSpec

    spec = LoRASpec(rank=128, alpha=64.0)
    opt = OptimizerSpec(optimizer="adamw", learning_rate=1e-4, beta1=0.9, beta2=0.95, weight_decay=1e-4,
                        epsilon=1e-8, max_grad_norm=1.0, moment_dtype="bfloat16")
    r = train_steps(pipe, dev, 480, 720, 49, steps, spec, opt, backend)
    L = pipe.transformer_cfg.num_layers
    problems = []
    if r["batch_shape"] != [1, 13, 60, 90, 16]:
        problems.append(f"batch {r['batch_shape']}")
    if not all(np.isfinite(r["losses"])):
        problems.append(f"losses {r['losses']}")
    if not r["base_unchanged"]:
        problems.append("a base parameter changed")
    if not r["b_nonzero"][0]:
        problems.append("every b is still zero after step 1")
    for i, c in enumerate(r["launches"]):
        # forward kernels: the forward and the remat recompute of each block; backward: one per block
        if not check_counts(c, backend, 2 * L, L):
            problems.append(f"step {i} launches {c}")
    if r["export_keys"] != 2 * (7 * L + 2):
        problems.append(f"export keys {r['export_keys']}")
    if problems:
        raise AssertionError(f"train ({backend}): {problems}; {r}")
    emit({"phase": name or ("train" if backend == "flash" else f"train_{backend}"), "backend": backend,
          "steps": steps, **(extra or {}), **r})
    return r


def _quantized(pipe):
    """The pipeline's DiT quantized on the card (int8 linears), and the
    seconds it took."""
    import torch

    from s2v_torch.ops.quant import quantize_transformer_params

    t0 = time.perf_counter()
    params = quantize_transformer_params(pipe.transformer_params)
    torch.cuda.synchronize()
    return params, time.perf_counter() - t0


def _weights_gb(params) -> float:
    tensors = [t for layer in params["blocks"] for t in _tensors(layer)]
    tensors += [t for k, v in params.items() if k != "blocks" for t in _tensors(v)]
    return sum(t.numel() * t.element_size() for t in tensors) / 1e9


def phase_e2e_int8(dev, pipe, backend="flash_int8"):
    """``generate`` as ``e2e`` on the int8 DiT with int8-QK attention: per
    step 42 B3 launches and no B1.  The bf16 tree is restored after."""
    bf16_params = pipe.transformer_params
    params, quantize_s = _quantized(pipe)
    pipe.transformer_params = params
    try:
        return phase_e2e(dev, pipe, backend, name="e2e_int8",
                         extra={"quantize_s": quantize_s, "weights_gb": _weights_gb(params)})
    finally:
        pipe.transformer_params = bf16_params


_SP_MESH = []


def sp_mesh():
    """The one-rank ``seq`` mesh of the SP phases: an NCCL process group of
    world size 1 over a ``HashStore`` (no network, no environment
    variables), made on first use; one all_reduce runs at once, so a failed
    NCCL start fails here.  No other backend stands in."""
    if not _SP_MESH:
        import torch
        import torch.distributed as dist
        from torch.distributed.device_mesh import init_device_mesh

        t0 = time.perf_counter()
        dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
        mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("seq",))
        x = torch.ones(1, device="cuda")
        dist.all_reduce(x, group=mesh.get_group("seq"))
        torch.cuda.synchronize()
        if x.item() != 1.0:
            raise AssertionError(f"a one-rank all_reduce gave {x.item()}")
        emit({"phase": "process_group", "backend": dist.get_backend(), "world_size": dist.get_world_size(),
              "mesh_dims": list(mesh.mesh_dim_names), "nccl": ".".join(map(str, torch.cuda.nccl.version())),
              "init_s": time.perf_counter() - t0})
        _SP_MESH.append(mesh)
    return _SP_MESH[0]


def phase_e2e_sp_windowed(dev, pipe, backend="sp_windowed"):
    """``generate`` as ``e2e_windowed`` (w = 2) on the one-rank seq mesh
    with ``sp_windowed``: per step 42 B6 and 42 B1 (global queries), no B4.
    The mesh is detached after."""
    pipe.set_mesh(sp_mesh())
    try:
        return phase_e2e(dev, pipe, backend, name="e2e_sp_windowed", extra={"seq_ring": pipe._seq_ring()})
    finally:
        pipe.set_mesh(None)


def phase_train_sp_windowed(dev, pipe, backend="sp_windowed"):
    """The ``train`` phase's steps with ``sp_windowed`` under the one-rank
    seq mesh's context: per step B6 and B1 twice per block, B7 and B2 once."""
    from s2v_torch.parallel import default_logical_map, mesh_context

    mesh = sp_mesh()
    with mesh_context(mesh, default_logical_map(mesh)):
        return phase_train(dev, pipe, backend, name="train_sp_windowed")


def phase_train_qlora(dev, pipe, backend="flash"):
    """QLoRA: the ``train`` phase's steps over the int8 base, flash both
    ways (B3 has no backward).  The int8 q and scale must not change.  The
    bf16 tree is restored after."""
    import torch

    from s2v_torch.ops.quant import QUANTIZED_LEAVES

    bf16_params = pipe.transformer_params
    params, quantize_s = _quantized(pipe)
    pipe.transformer_params = params
    try:
        r = phase_train(dev, pipe, backend, name="train_qlora", extra={"quantize_s": quantize_s})
    finally:
        pipe.transformer_params = bf16_params
    int8_leaves = [layer[g][n] for layer in params["blocks"] for g, n in QUANTIZED_LEAVES]
    if not all(leaf["q"].dtype == torch.int8 and leaf["scale"].dtype == torch.float32 for leaf in int8_leaves):
        raise AssertionError("train_qlora: an int8 leaf changed its dtype")
    return r


PHASES = ("build", "kernel", "kernel_bwd", "kernel_banded", "kernel_banded_bwd", "kernel_banded_local",
          "kernel_banded_local_bwd", "kernel_int8", "reference", "e2e", "e2e_windowed", "e2e_sp_windowed", "e2e_int8",
          "train", "train_windowed", "train_sp_windowed", "train_qlora")
KERNEL_PHASES = {"kernel": phase_kernel, "kernel_bwd": phase_kernel_bwd, "kernel_banded": phase_kernel_banded,
                 "kernel_banded_bwd": phase_kernel_banded_bwd, "kernel_banded_local": phase_kernel_banded_local,
                 "kernel_banded_local_bwd": phase_kernel_banded_local_bwd, "kernel_int8": phase_kernel_int8,
                 "reference": phase_reference}
# the pipeline phases: the backend each runs
PATH_PHASES = {"e2e": (phase_e2e, "flash"), "e2e_windowed": (phase_e2e, "windowed"),
               "e2e_sp_windowed": (phase_e2e_sp_windowed, "sp_windowed"),
               "e2e_int8": (phase_e2e_int8, "flash_int8"), "train": (phase_train, "flash"),
               "train_windowed": (phase_train, "windowed"),
               "train_sp_windowed": (phase_train_sp_windowed, "sp_windowed"),
               "train_qlora": (phase_train_qlora, "flash")}


def _path_launches(results, kernel):
    """A kernel's launches on each pipeline phase's run (summed over a
    train phase's steps, the profiled step not included)."""
    out = {}
    for phase, r in results.items():
        if phase.startswith("e2e"):
            out[phase] = r[kernel]
        elif phase.startswith("train"):
            out[phase] = sum(c[kernel] for c in r["launches"])
    return out


def kernels_line(results):
    """The kernels line: each kernel with its route, source, the TPU kernel
    it replaces, its launches on its main path (and on every path), its
    agreement with the plain version beside the limits, and its times."""
    worst = lambda stats, key: max(v[key] for v in stats.values())  # noqa: E731
    main, bwd = results["kernel"], results["kernel_bwd"]
    banded, banded_bwd = results["kernel_banded"], results["kernel_banded_bwd"]
    int8 = results["kernel_int8"]
    local, local_bwd = results["kernel_banded_local"], results["kernel_banded_local_bwd"]
    common = {"route": "cuda", "rel_l2_tol": OUT_L2_REL}
    return [{
        **common,
        "name": "flash_attention",
        "source": "s2v_torch/csrc/flash_attention.cu",
        "headers": ["s2v_torch/csrc/hopper.cuh"],
        "replaces": "s2v_tpu/ops/pallas/flash_attention.py:222",
        "launches": results["e2e"]["flash_attention"],
        "launches_by_path": _path_launches(results, "flash_attention"),
        # the worst mode at the main shape, beside what it was held to
        "max_abs_err": worst(main["modes"], "max_abs_err"),
        "max_abs_tol": main["modes"][MAIN_MODE]["max_abs_tol"],
        "rel_l2": worst(main["modes"], "rel_l2"),
        "ref_rms": main["modes"][MAIN_MODE]["ref_rms"],
        "ms": main["modes"][MAIN_MODE]["ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "library_ms": main["library_ms"],
        "mode": MAIN_MODE,
        "ms_by_mode": {m: v["ms"] for m, v in main["modes"].items()},
        "tflops": main["tflops"],
        "smem_bytes": main["smem_bytes"],
        "with_lse_b1_ms": bwd["b1_with_lse_ms"],
        "shape": list(MAIN_SHAPE),
    }, {
        **common,
        "name": "flash_attention_bwd",
        "source": "s2v_torch/csrc/flash_attention_bwd.cu",
        "headers": ["s2v_torch/csrc/hopper.cuh"],
        "replaces": "s2v_tpu/ops/pallas/flash_attention_bwd.py:128",
        "launches": sum(c["flash_attention_bwd"] for c in results["train"]["launches"]),
        "launches_by_path": _path_launches(results, "flash_attention_bwd"),
        # the worst of dq, dk, dv at the training shape, beside what it was held to
        "max_abs_err": worst(bwd["grads"], "max_abs_err"),
        "max_abs_tol": min(v["max_abs_tol"] for v in bwd["grads"].values()),
        "rel_l2": worst(bwd["grads"], "rel_l2"),
        "ms": bwd["ms"],
        "plain_ms": bwd["plain_ms"],
        "bound_ms": bwd["bound_ms"],
        "bound_by": bwd["bound_by"],
        "library_ms": bwd["library_ms"],
        "tflops": bwd["tflops"],
        "parts_ms": bwd["parts_ms"],
        "smem_bytes": bwd["smem_bytes"],
        "deterministic": bwd["deterministic"],
        "schedule_max_abs_err": max(v["schedule_max_abs_err"] for v in bwd["grads"].values()),
        "shape": list(TRAIN_SHAPE),
    }, {
        **common,
        "name": "banded_flash_attention",
        "source": "s2v_torch/csrc/banded_attention.cu",
        "headers": ["s2v_torch/csrc/hopper.cuh", "s2v_torch/csrc/band.cuh"],
        "replaces": "s2v_tpu/ops/pallas/banded_attention.py:155",
        "launches": results["e2e_windowed"]["banded_flash_attention"],
        "launches_by_path": _path_launches(results, "banded_flash_attention"),
        "max_abs_err": banded["max_abs_err"],
        "max_abs_tol": banded["max_abs_tol"],
        "rel_l2": banded["rel_l2"],
        "lse_err": banded["lse_err"],
        "lse_tol": LSE_TOL,
        # the whole function: the banded launch and the global queries' B1 call
        "ms": banded["ms"],
        "plain_ms": banded["plain_ms"],
        "bound_ms": banded["bound_ms"],
        "bound_by": banded["bound_by"],
        # the video queries alone: the banded launch and the masked SDPA call
        "video_launch_ms": banded["video_launch_ms"],
        "video_bound_ms": banded["video_bound_ms"],
        "video_tflops": banded["video_tflops"],
        "smem_bytes": banded["smem_bytes"],
        "small_worst_schedule_share": banded["small_worst_schedule_share"],
        "library_ms": banded["library_ms"],
        "library_shape": banded["library_shape"],
        "library_covers": "video queries (masked SDPA)",
        "gather_path_ms": banded["gather_path_ms"],
        "shape": list(MAIN_SHAPE),
        "band": list(BAND),
    }, {
        **common,
        "name": "banded_flash_attention_bwd",
        "source": "s2v_torch/csrc/banded_attention_bwd.cu",
        "headers": ["s2v_torch/csrc/hopper.cuh", "s2v_torch/csrc/band.cuh"],
        "replaces": "s2v_tpu/ops/pallas/banded_attention_bwd.py:178",
        "launches": sum(c["banded_flash_attention_bwd"] for c in results["train_windowed"]["launches"]),
        "launches_by_path": _path_launches(results, "banded_flash_attention_bwd"),
        "max_abs_err": worst(banded_bwd["grads"], "max_abs_err"),
        "max_abs_tol": min(v["max_abs_tol"] for v in banded_bwd["grads"].values()),
        "rel_l2": worst(banded_bwd["grads"], "rel_l2"),
        # the whole function: the banded pair, the global queries' B2 call, D and the sums
        "ms": banded_bwd["ms"],
        "plain_ms": banded_bwd["plain_ms"],
        "bound_ms": banded_bwd["bound_ms"],
        "bound_by": banded_bwd["bound_by"],
        "video_launch_ms": banded_bwd["video_launch_ms"],
        "video_bound_ms": banded_bwd["video_bound_ms"],
        "video_tflops": banded_bwd["video_tflops"],
        "video_parts_ms": banded_bwd["video_parts_ms"],
        "deterministic": banded_bwd["deterministic"],
        "smem_bytes": banded_bwd["smem_bytes"],
        "small_worst_schedule_share": banded_bwd["small_worst_schedule_share"],
        "library_ms": banded_bwd["library_ms"],
        "library_shape": banded_bwd["library_shape"],
        "library_covers": "video queries (backward of masked SDPA)",
        "shape": list(TRAIN_SHAPE),
        "band": list(BAND),
    }, {
        **common,
        "name": "flash_attention_qk_int8",
        "source": "s2v_torch/csrc/int8_attention.cu",
        "headers": ["s2v_torch/csrc/hopper.cuh"],
        "replaces": "s2v_tpu/ops/pallas/int8_attention.py:99",
        "launches": results["e2e_int8"]["flash_attention_qk_int8"],
        "launches_by_path": _path_launches(results, "flash_attention_qk_int8"),
        "prepass_launches": results["e2e_int8"]["flash_attention_qk_int8_prepass"],
        "max_abs_err": int8["max_abs_err"],
        "max_abs_tol": int8["max_abs_tol"],
        "rel_l2": int8["rel_l2"],
        "prepass_bit_equal": int8["prepass_bit_equal"],
        "deterministic": int8["deterministic"],
        "small_worst_schedule_share": int8["small_worst_schedule_share"],
        # the whole function: the pre-pass kernels and the main launch
        "ms": int8["ms"],
        "launch_ms": int8["launch_ms"],
        "prepass_ms": int8["prepass_ms"],
        "prepass_bound_ms": int8["prepass_bound_ms"],
        "torch_prepass_ms": int8["torch_prepass_ms"],
        "plain_ms": int8["plain_ms"],
        "bound_ms": int8["bound_ms"],
        "bound_by": int8["bound_by"],
        "bound_set_by": int8["bound_set_by"],
        "bound_parts_ms": int8["bound_parts_ms"],
        "launch_tops": int8["launch_tops"],
        "launch_bound_share": int8["launch_bound_share"],
        "smem_bytes": int8["smem_bytes"],
        "library_ms": None,
        "library_note": f"no PyTorch call computes int8-QK attention; B1 online at the same shape: "
                        f"{int8['b1_online_ms']:.2f} ms",
        "b1_online_ms": int8["b1_online_ms"],
        "shape": list(MAIN_SHAPE),
    }, {
        **common,
        "name": "banded_flash_attention_local",
        "source": "s2v_torch/csrc/banded_attention.cu",
        "headers": ["s2v_torch/csrc/hopper.cuh", "s2v_torch/csrc/band.cuh"],
        "replaces": "s2v_tpu/ops/pallas/banded_attention.py:281",
        "launches": results["e2e_sp_windowed"]["banded_flash_attention_local"],
        "launches_by_path": _path_launches(results, "banded_flash_attention_local"),
        # at the main path's shape (one rank: q the 17,550 video rows, k/v all 19,126)
        "max_abs_err": local["stitched"]["plain"]["max_abs_err"],
        "max_abs_tol": local["stitched"]["plain"]["max_abs_tol"],
        "rel_l2": local["stitched"]["plain"]["rel_l2"],
        "lse_err": local["stitched"]["plain"]["lse_err"],
        "lse_tol": LSE_TOL,
        # the worst small case over every offset of the 2- and 4-rank rings, as a share of its limit
        "small_worst_err_share": local["small_worst_err_share"],
        "small_worst_schedule_share": local["small_worst_schedule_share"],
        "tflops": local["timed"]["ring1"]["tflops"],
        "stitched_vs_b4": {k: v for k, v in local["stitched"].items() if k != "plain"},
        **_timed_fields(local["timed"]),
        "library_covers": "the shard's video queries (masked SDPA)",
        "q_shape": local["q_shape_ring1"],
        "shape": list(MAIN_SHAPE),
        "band": list(BAND),
    }, {
        **common,
        "name": "banded_flash_attention_local_bwd",
        "source": "s2v_torch/csrc/banded_attention_bwd.cu",
        "headers": ["s2v_torch/csrc/hopper.cuh", "s2v_torch/csrc/band.cuh"],
        "replaces": "s2v_tpu/ops/pallas/banded_attention_bwd.py:375",
        "launches": sum(c["banded_flash_attention_local_bwd"] for c in results["train_sp_windowed"]["launches"]),
        "launches_by_path": _path_launches(results, "banded_flash_attention_local_bwd"),
        "max_abs_err": worst(local_bwd["stitched"]["plain"], "max_abs_err"),
        "max_abs_tol": min(v["max_abs_tol"] for v in local_bwd["stitched"]["plain"].values()),
        "rel_l2": worst(local_bwd["stitched"]["plain"], "rel_l2"),
        "small_worst_err_share": local_bwd["small_worst_err_share"],
        "small_worst_schedule_share": local_bwd["small_worst_schedule_share"],
        "tflops": local_bwd["timed"]["ring1"]["tflops"],
        "parts_ms": local_bwd["parts_ms_ring1"],
        "deterministic": local_bwd["deterministic"],
        "stitched_vs_b5": {k: v for k, v in local_bwd["stitched"].items() if k != "plain"},
        "dummy_frames": local_bwd["dummy_frames"],
        **_timed_fields(local_bwd["timed"]),
        "library_covers": "the shard's video queries (backward of masked SDPA)",
        "q_shape": [TRAIN_SHAPE[0], TRAIN_SHAPE[1] - BAND[0], *TRAIN_SHAPE[2:]],
        "shape": list(TRAIN_SHAPE),
        "band": list(BAND),
    }]


def _timed_fields(timed):
    """A SP kernel's times at one rank (its main-path shape) and per shard of
    a 4-rank ring."""
    one = timed["ring1"]
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "library_shape")
    return {**{k: one[k] for k in keys},
            "per_shard_ring4": [{k: t[k] for k in ("rank", "offset", "dummy_frames", "ms", "plain_ms", "bound_ms",
                                                     "library_ms")} for t in timed["ring4"]]}


def main(argv=None) -> int:
    import argparse

    import torch
    import torch.distributed

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--phases", default=",".join(PHASES),
                        help="comma-separated subset of the phases, for a short check of one part; "
                             "a subset prints no kernels line and no result line")
    args = parser.parse_args(argv)
    phases = args.phases.split(",")
    unknown = sorted(set(phases) - set(PHASES))
    if unknown:
        parser.error(f"unknown phases {unknown}; choose from {PHASES}")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (REPO / "s2v_torch").is_dir():
        print("chip_smoke: run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions compute in full fp32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    name = torch.cuda.get_device_name(0)
    emit({"phase": "device", "name": name, "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    phase_build()  # always: every other phase needs the kernels
    # the kernel phases first, while the card's memory is free; then the
    # full-width pipeline, built once for every pipeline phase
    results, pipe = {}, None
    try:
        for phase in [p for p in PHASES if p in phases and p != "build"]:
            if phase in KERNEL_PHASES:
                results[phase] = KERNEL_PHASES[phase](dev)
            else:
                pipe = pipe or build_full_pipe(dev)
                fn, backend = PATH_PHASES[phase]
                results[phase] = fn(dev, pipe, backend)
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
    if "e2e_windowed" in results and "e2e_sp_windowed" in results:
        # the same seed through B4 and through B6 on one rank: the limits of a kernel against its plain version
        sp, single = results["e2e_sp_windowed"]["latents"], results["e2e_windowed"]["latents"]
        line = {"phase": "sp_windowed_vs_windowed",
                "latents_1_step": {**_agreement(sp, single, "e2e_sp_windowed latents against e2e_windowed's"),
                                   "bitwise_equal": bool(torch.equal(sp, single))}}
        if "train_windowed" in results and "train_sp_windowed" in results:
            line["first_loss_windowed"] = results["train_windowed"]["losses"][0]
            line["first_loss_sp_windowed"] = results["train_sp_windowed"]["losses"][0]
        emit(line)
    if "train" in results and "train_qlora" in results:
        # a finding, not a gate: the JAX package's test holds the QLoRA loss
        # to rtol 0.05 of the bf16-base loss on its tiny model
        exact, qlora = results["train"]["losses"][0], results["train_qlora"]["losses"][0]
        emit({"phase": "qlora_vs_exact", "first_loss_exact": exact, "first_loss_qlora": qlora,
              "relative": abs(qlora / exact - 1), "jax_test_rtol": 0.05})
    if phases != list(PHASES):
        print(smi, flush=True)
        return 0
    emit({"kernels": kernels_line(results), "seconds": time.perf_counter() - t_start})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
