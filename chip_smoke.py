#!/usr/bin/env python3
"""Smoke run of the s2v_torch port on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line:
  1. device   — the card's name, count, and nvidia-smi's name and power limit;
  2. build    — every kernel built from the checkout's sources (one compiler
                process per source, all started together);
  3. kernel   — kernel B1 (flash attention) against its plain PyTorch version
                on the card, in every softmax mode: small ragged / masked /
                Sq != Skv shapes with lse, an input that forces the bounded
                mode's online re-run, and the main-path shape B=2, H=48,
                S=19,126, d=64, timed beside its bound, the plain version and
                one ``F.scaled_dot_product_attention`` call (a yardstick only:
                the port never calls it);
  4. kernel_bwd — kernel B2 (flash attention backward) against its plain
                PyTorch version: small ragged shapes with Sq != Skv, and the
                training shape B=1, H=48, S=19,126, d=64 (q/k LayerNormed,
                lse from B1, dO seeded), timed beside its bound, the plain
                version and the backward of one SDPA call (a yardstick only);
  5. reference — a small bf16 pipeline on the card, flash kernel against
                the plain fp32 attention on the same weights and noise;
  6. e2e      — ``S2VPipeline.generate`` at full CogVideoX-5b width (42-block
                DiT, T5-XXL, the full VAE; random weights from fixed seeds):
                49 frames at 480x720, 2 DDIM steps, batched CFG; the launch
                counts are zeroed just before and read just after;
  7. train    — on the same pipeline: one seeded 49x480x720 clip through
                ``latent_batches`` (RoPE tables added), then 3 LoRA train
                steps (rank 128 on all seven target families, flash both
                ways, remat, adamw with a bf16 first moment and clip 1.0);
                per step the counts are zeroed before and read after: B1
                twice per block (forward and recompute), B2 once per block;
                then one more step under ``torch.profiler`` (device time by
                kernel family, the device's idle share).
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
MODES = ("online", "bounded", "bounded_exp2")
MAIN_MODE = "bounded"  # the softmax mode the DiT's attention uses
# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
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
    from s2v_torch.kernels.flash_attention import SOURCE as FLASH_SRC
    from s2v_torch.kernels.flash_attention_bwd import SOURCE as FLASH_BWD_SRC
    from s2v_torch.utils import native_build
    from s2v_torch.utils.sp_native import SOURCE as SP_SRC

    t0 = time.perf_counter()
    results = native_build.build([FLASH_SRC, FLASH_BWD_SRC, SP_SRC])
    # per kernel: its registers, spills and shared memory
    ptxas = {src.stem: [ln.strip() for ln in results[src.stem]["log"].splitlines()
                        if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
             for src in (FLASH_SRC, FLASH_BWD_SRC)}
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

    from s2v_torch.kernels.flash_attention import flash_attention, flash_attention_reference

    small = []
    for mode in MODES:
        for (b, sq, skv, h, masked) in [(2, 200, 200, 3, False), (1, 77, 333, 2, True), (2, 1000, 129, 2, False)]:
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
    result = {"phase": "kernel_main", "shape": list(MAIN_SHAPE), "modes": main, "plain_ms": plain_ms,
              "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by,
              "tflops": flops / main[MAIN_MODE]["ms"] / 1e9, "reruns": flash_attention.reruns}
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
    from s2v_torch.kernels.flash_attention_bwd import flash_attention_bwd, flash_attention_bwd_reference

    got = flash_attention_bwd(q, k, v, o, lse, do)
    want = flash_attention_bwd_reference(q, k, v, o, lse, do)
    what = f"flash_attention_bwd {tuple(q.shape)}x{tuple(k.shape)}"
    return {name: _agreement(a, r, f"{what} {name}") for name, a, r in zip(("dq", "dk", "dv"), got, want)}


def phase_kernel_bwd(dev):
    """Kernel B2 against its plain version: small ragged shapes (Sq != Skv),
    then the training shape, timed beside its bound, the plain version and
    the backward of one ``F.scaled_dot_product_attention`` (a yardstick
    only: the port never calls it)."""
    import torch
    import torch.nn.functional as F

    from s2v_torch.kernels.flash_attention import flash_attention
    from s2v_torch.kernels.flash_attention_bwd import flash_attention_bwd, flash_attention_bwd_reference

    small = []
    for (b, sq, skv, h) in [(2, 200, 200, 3), (1, 77, 333, 2), (2, 1000, 129, 2)]:
        small.append({"q": [b, sq, h, 64], "skv": skv, **_compare_bwd(*_bwd_inputs(b, sq, skv, h, sq + skv, dev))})
    emit({"phase": "kernel_bwd_small", "cases": small})

    b, s, h, d = TRAIN_SHAPE
    q, k, v, o, lse, do = _bwd_inputs(b, s, s, h, 11, dev, layer_norm=True)
    stats = _compare_bwd(q, k, v, o, lse, do)
    # B1 as the train step calls it (with lse), at the same shape
    b1_ms = cuda_ms(lambda: flash_attention(q, k, v, return_lse=True, softmax_mode=MAIN_MODE), 10)
    flash_attention_bwd(q, k, v, o, lse, do)  # warm-up
    ms = cuda_ms(lambda: flash_attention_bwd(q, k, v, o, lse, do), 10)
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
              "tflops": flops / ms / 1e9, "b1_with_lse_ms": b1_ms}
    emit(result)
    return result


def phase_reference(dev):
    """A small bf16 pipeline with d=64 heads: the flash kernel path against
    the plain fp32 attention path, on the same weights, inputs and noise."""
    import torch

    from s2v_torch import S2VPipeline, TransformerConfig, VAEConfig
    from s2v_torch.models.transformer import init_transformer_params_random
    from s2v_torch.models.vae import init_vae_params_random

    tcfg = TransformerConfig.tiny(num_attention_heads=2, attention_head_dim=64, dtype=torch.bfloat16)
    vcfg = VAEConfig.tiny(latent_channels=4, sample_height=64, sample_width=64, dtype=torch.bfloat16)
    pipe = S2VPipeline(init_transformer_params_random(tcfg, seed=3, device=dev, scale=0.1), tcfg,
                       init_vae_params_random(vcfg, seed=4, device=dev), vcfg, device=dev)
    g = np.random.RandomState(0)
    kw = dict(prompt_embeds=torch.from_numpy(g.randn(2, 16, 32).astype(np.float32)),
              ref_image=np.clip(g.randn(32, 32, 3) * 0.5, -1, 1), height=32, width=32, num_frames=9,
              num_inference_steps=2, guidance_scale=2.0, output_type="latent", seed=1)
    pipe.attention_backend = "flash"
    flash = pipe.generate(**kw).float()
    pipe.attention_backend = "plain"
    plain = pipe.generate(**kw).float()
    err = (flash - plain).abs().max().item()
    rel = err / plain.abs().max().item()
    if not (torch.isfinite(flash).all() and rel < PIPELINE_REL_TOL):
        raise AssertionError(f"small pipeline: flash vs plain max_abs_err {err}, relative {rel} "
                             f"(tol {PIPELINE_REL_TOL})")
    emit({"phase": "reference", "max_abs_err": err, "relative_err": rel, "rel_tol": PIPELINE_REL_TOL,
          "shape": list(flash.shape)})


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


def phase_e2e(dev, pipe, num_frames=49):
    import torch

    from s2v_torch.kernels.flash_attention import flash_attention
    from s2v_torch.kernels.flash_attention_bwd import flash_attention_bwd

    tcfg = pipe.transformer_cfg
    image = np.clip(np.random.RandomState(42).randn(480, 720, 3).astype(np.float32) * 0.5, -1, 1)
    torch.cuda.reset_peak_memory_stats()

    flash_attention.launches = 0
    flash_attention.reruns = 0
    flash_attention_bwd.launches = 0
    t0 = time.perf_counter()
    video = pipe.generate(prompt="a pig walking in the park", ref_image=image, height=480, width=720,
                          num_frames=num_frames, num_inference_steps=2, guidance_scale=6.0, seed=42)
    wall_s = time.perf_counter() - t0
    launches, reruns, bwd_launches = flash_attention.launches, flash_attention.reruns, flash_attention_bwd.launches

    expected = (1, num_frames, 480, 720, 3)
    if video.shape != expected or not np.isfinite(video).all() or video.min() < 0 or video.max() > 1:
        raise AssertionError(f"generate output {video.shape}, finite {np.isfinite(video).all()}, "
                             f"range [{video.min()}, {video.max()}]")
    if launches - reruns != 2 * tcfg.num_layers or bwd_launches:
        raise AssertionError(f"flash launches {launches} with {reruns} re-runs, {bwd_launches} backward; "
                             f"expected {2 * tcfg.num_layers} and 0")
    timings = pipe.timings
    emit({"phase": "e2e", "num_frames": num_frames, "steps": 2, "output_shape": list(video.shape),
          "flash_launches": launches, "online_reruns": reruns,
          "encode_prompt_s": timings["encode_prompt_s"], "encode_ref_s": timings["encode_ref_s"],
          "denoise_step_s": timings["denoise_step_s"], "decode_s": timings["decode_s"], "wall_s": wall_s,
          "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
          "output_mean": float(video.mean()), "output_std": float(video.std())})
    return launches


def train_steps(pipe, dev, height, width, num_frames, steps, spec, optimizer_spec, backend):
    """Encode one seeded clip through ``latent_batches``, then run ``steps``
    LoRA train steps on ``pipe``'s DiT with remat.  The launch counts are
    zeroed before and read after each step.  On CUDA one more step runs
    under ``torch.profiler``.  Returns what the phase checks and prints;
    runs on the CPU too (at a tiny size, where no kernel launches)."""
    import torch

    from s2v_torch.kernels.flash_attention import flash_attention
    from s2v_torch.kernels.flash_attention_bwd import flash_attention_bwd
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
        flash_attention.launches = flash_attention.reruns = flash_attention_bwd.launches = 0  # counts zeroed
        t0 = time.perf_counter()
        lora, opt_state, loss = step(lora, opt_state, batch, gen)
        sync()
        step_s.append(time.perf_counter() - t0)
        counts.append({"flash_attention": flash_attention.launches, "reruns": flash_attention.reruns,
                       "flash_attention_bwd": flash_attention_bwd.launches})
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
    return {"device_ms_by_family": {k: v / 1e3 for k, v in sorted(by_family.items(), key=lambda kv: -kv[1])},
            "busy_ms": busy / 1e3, "window_ms": window / 1e3, "idle_share": 1.0 - busy / window,
            "kernel_launches": len(kernels), "top_kernels_ms": {k[:80]: v / 1e3 for k, v in top}}


def _tensors(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    return [tree]


def phase_train(dev, pipe, steps=3):
    """Three LoRA train steps of the full-width DiT (rank 128, all seven
    target families, flash attention both ways, remat) on one 49x480x720
    clip, with the template optimizer (adamw, bf16 first moment, clip 1.0),
    then a fourth under ``torch.profiler``: its device time by kernel family
    and the device's idle share."""
    from s2v_torch.training.lora import LoRASpec
    from s2v_torch.training.optim import OptimizerSpec

    spec = LoRASpec(rank=128, alpha=64.0)
    opt = OptimizerSpec(optimizer="adamw", learning_rate=1e-4, beta1=0.9, beta2=0.95, weight_decay=1e-4,
                        epsilon=1e-8, max_grad_norm=1.0, moment_dtype="bfloat16")
    r = train_steps(pipe, dev, 480, 720, 49, steps, spec, opt, "flash")
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
        # B1: the forward and the remat recompute of each block (+ re-runs); B2: one backward per block
        if c["flash_attention"] - c["reruns"] != 2 * L or c["flash_attention_bwd"] != L:
            problems.append(f"step {i} launches {c}")
    if r["export_keys"] != 2 * (7 * L + 2):
        problems.append(f"export keys {r['export_keys']}")
    if problems:
        raise AssertionError(f"train: {problems}; {r}")
    emit({"phase": "train", "steps": steps, **r})
    return r


PHASES = ("build", "kernel", "kernel_bwd", "reference", "e2e", "train")
PHASE_FNS = {"kernel": phase_kernel, "kernel_bwd": phase_kernel_bwd, "reference": phase_reference}


def main(argv=None) -> int:
    import argparse

    import torch

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
    if phases != list(PHASES):
        pipe = None
        for name in phases:
            if name in ("kernel", "kernel_bwd", "reference"):
                PHASE_FNS[name](dev)
            elif name == "e2e":
                pipe = pipe or build_full_pipe(dev)
                phase_e2e(dev, pipe)
            elif name == "train":
                pipe = pipe or build_full_pipe(dev)
                phase_train(dev, pipe)
        print(smi, flush=True)
        return 0
    main_kernel = phase_kernel(dev)
    bwd_kernel = phase_kernel_bwd(dev)  # before the pipeline, while the card's memory is free
    phase_reference(dev)
    pipe = build_full_pipe(dev)
    launches = phase_e2e(dev, pipe)
    train = phase_train(dev, pipe)

    worst = lambda stats, key: max(v[key] for v in stats.values())  # noqa: E731
    emit({"kernels": [{
        "name": "flash_attention",
        "route": "cuda",
        "source": "s2v_torch/csrc/flash_attention.cu",
        "replaces": "s2v_tpu/ops/pallas/flash_attention.py:222",
        "launches": launches,
        "launches_train": sum(c["flash_attention"] for c in train["launches"]),
        # the worst mode at the main shape, beside what it was held to
        "max_abs_err": worst(main_kernel["modes"], "max_abs_err"),
        "max_abs_tol": main_kernel["modes"][MAIN_MODE]["max_abs_tol"],
        "rel_l2": worst(main_kernel["modes"], "rel_l2"),
        "ref_rms": main_kernel["modes"][MAIN_MODE]["ref_rms"],
        "ms": main_kernel["modes"][MAIN_MODE]["ms"],
        "plain_ms": main_kernel["plain_ms"],
        "bound_ms": main_kernel["bound_ms"],
        "bound_by": main_kernel["bound_by"],
        "library_ms": main_kernel["library_ms"],
        "mode": MAIN_MODE,
        "ms_by_mode": {m: v["ms"] for m, v in main_kernel["modes"].items()},
        "shape": list(MAIN_SHAPE),
    }, {
        "name": "flash_attention_bwd",
        "route": "cuda",
        "source": "s2v_torch/csrc/flash_attention_bwd.cu",
        "replaces": "s2v_tpu/ops/pallas/flash_attention_bwd.py:128",
        "launches": sum(c["flash_attention_bwd"] for c in train["launches"]),
        # the worst of dq, dk, dv at the training shape, beside what it was held to
        "max_abs_err": worst(bwd_kernel["grads"], "max_abs_err"),
        "max_abs_tol": min(v["max_abs_tol"] for v in bwd_kernel["grads"].values()),
        "rel_l2": worst(bwd_kernel["grads"], "rel_l2"),
        "rel_l2_tol": OUT_L2_REL,
        "ms": bwd_kernel["ms"],
        "plain_ms": bwd_kernel["plain_ms"],
        "bound_ms": bwd_kernel["bound_ms"],
        "bound_by": bwd_kernel["bound_by"],
        "library_ms": bwd_kernel["library_ms"],
        "shape": list(TRAIN_SHAPE),
    }], "seconds": time.perf_counter() - t_start})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
