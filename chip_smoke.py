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
      kernel_fp16, kernel_bwd_fp16 — B1 and B2 in fp16 (the 2b family)
                against their plain versions with the same limits (B2 also
                against its schedule's emulation, two launches bit for bit):
                small ragged shapes, then B1 at the 2b shapes [2, 19,126,
                30, 64] (s2v) and [2, 17,776, 30, 64] (t2v) in both softmax
                modes and B2 at [1, 19,126, 30, 64], timed beside their
                bounds at 989 TFLOP/s dense fp16 and fp16 SDPA (forward,
                backward); B1 with one q row x4 (rows far below M0 must
                re-run online), no re-run allowed in the timed bounded
                mode; B2 also at dO 2^-10, where fp16 would flush an
                unscaled dS (zero shares and dS shares printed);
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
                4-rank ring, dummy frames included (rings with more ranks
                than frames: phase ring_past_frames); then the main
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
      kernel_fp32, kernel_bwd_fp32, kernel_banded_fp32,
      kernel_banded_bwd_fp32, kernel_banded_local_fp32,
      kernel_banded_local_bwd_fp32 — the fp32 forms of B1, B2 and B4-B7
                (``csrc/attention_f32.cu``, ``attention_f32_bwd.cu``: 3xTF32
                on ``wgmma`` from the big and small planes a pre-pass
                writes) against their plain versions (TF32 matmuls off) and
                the emulations of their schedules: small ragged cases
                (every softmax mode, a key pad mask, a bounded re-run; every
                offset of 2- and 4-rank rings), then the main shapes (B=2
                forward, B=1 backward, S=19,126, H=48; the local forms per
                shard of a 4-rank ring; the emulations on the first two
                heads), timed over 3 launches beside the bound (the 3-pass
                TF32 floor; one TF32 pass beside it), the plain version and
                fp32 SDPA;
      kernel_int8_fp32 — kernel B3 in fp32 (int8 logits, 3xTF32 P·V):
                small ragged shapes against the plain version and the
                emulation of its schedule, the pre-pass kernels' int8 values
                and dq equal to the plain pre-pass's everywhere; the main
                shape B=2, S=19,126, H=48 against the plain version, two
                launches bit for bit, timed (whole, pre-pass, main launch)
                beside its bound and the plain version;
      int8_widths — the int8 linears at widths that are not multiples of 8
                (20 -> 36, 7 -> 13): the card's padded int32 products equal
                to the CPU's bit for bit;
      kernel_qk_norm_rope — the q/k LayerNorms and RoPE kernel (the port's
                own; no Pallas counterpart) against the emulation of its
                arithmetic and the plain chain: small ragged shapes on
                strided qkv views, then the 5b shape (bf16, the segmented
                tables) and the 2b shape (fp16, no tables), timed over 10
                launches beside the bound (q and k read and written once at
                3.35 TB/s) and the plain chain;
      kernel_adaln — the adaLN-Zero LayerNorms, modulation and stream
                join kernel (the port's own; no Pallas counterpart) against
                the emulation of its arithmetic (one ulp) and the plain
                chain: small ragged shapes (a zero-width ref, strided
                streams, one stream, fp32 norm params), then the 5b, 2b and
                1.5 shapes, timed over 10 launches beside the bound (the
                streams read and the joined rows written once at 3.35
                TB/s), a contiguous copy of the same bytes and the plain
                chain;
      ring_past_frames — B6/B7 in bf16 on the shards of a 4-rank ring over
                2 latent frames (ranks 2-3 dummy only) and over the small
                geometries' short clips, against their plain versions;
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
      kernel_int8_fp16, kernel_banded_fp16, kernel_banded_bwd_fp16,
      kernel_banded_local_fp16, kernel_banded_local_bwd_fp16 — B3-B7 in
                fp16 (the 2b family), each against its plain version and,
                on small cases, the emulation of its schedule (P, and dS
                scaled by 2^e, rounded to fp16); then at the 2b shapes
                (H = 30: B=2 forward, B=1 backward, the 5b band) its fp16
                entry counted, timed over 10 launches beside its bound at
                989 TFLOP/s dense fp16, the plain version and one fp16 SDPA
                call with the boolean band mask (B3: fp16 B1 online); B5
                also at dO 2^-10, B5/B7 two launches bit for bit;
  10. reference — a small bf16 pipeline on the card, flash kernel against
                the plain fp32 attention on the same weights and noise, the
                same with the windowed backends (B4 against the gather path
                on the plain attention), and with the int8 tree
                (``flash_int8`` against the plain attention on the same
                quantized tree; the int8-vs-bf16 latent RMS printed);
      chunked  — the ``chunked`` backend (PyTorch ops, no kernel) at the
                training shape B=1, S=19,126, H=48, d=64: forward and autograd
                backward against B1 and B2 on the same inputs, within the
                kernels' limits; seconds, and the peak memory against one
                1,024-row block's fp32 probabilities (at most 8 of them);
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
      e2e_sp_allgather — ``generate`` as ``e2e``, at full depth, after
                ``set_mesh("sp1")`` (the same one-rank NCCL group) with the
                explicit backend ``sp_allgather``: 84 B1 launches; its clip
                and 1-step latents equal to ``e2e``'s bit for bit, else held
                to B1's limits with the reason (``sp_allgather_vs_e2e``),
                and the one-rank collectives' host and device time;
      e2e_sp_backends — on the one-rank mesh: ``sp_allgather``,
                ``sp_ulysses``, ``ring`` (B1, ring with its lse) and
                ``sp_int8`` (B3) against the kernels' plain versions at the
                main shape; then 2-step generates to latents with
                ``sp_ulysses`` and ``ring`` against ``flash`` and with
                ``sp_int8`` against ``flash_int8`` (bit for bit, or within
                B1's limits with the reason), each counted (one B1 a block
                and step, ring one per hop; ``sp_int8`` one B3 and one
                pre-pass, no B1), and one profiled step of each;
 14. e2e_int8 — the same on the int8 DiT (``quantize_transformer_params``,
                timed) with ``set_attention("flash_int8")``: per step 42 B3
                launches (and 42 of its pre-pass) and no B1; the bf16 tree
                is restored after;
      e2e_options — the rest of ``generate`` with ``flash``, 2 steps each: a
                DPM clip (84 B1 launches); the whole loop's latents against
                ``segment_steps=1``'s, bit for bit; a callback that stops the
                run after its first segment (one step, 42 launches); a cfg-skip
                run (dynamic guidance, threshold 0.02: 42 B1 launches at B=2
                and 42 at B=1); then the latents decoded untiled and in
                quarter-size tiles: seconds, peak memory, frame PSNR;
      turbo    — two 50-step clips, dynamic guidance, seed 42, T5 in each:
                exact (B1) and the JAX package's turbo knobs (int8 linears,
                ``windowed`` w = 1, cfg-skip 0.02, adaptive 0.05, segments of
                6): seconds per clip, step times, peak memory, skip counts
                (the cfg-skipped count equal to the guidance table's),
                launches by batch, and turbo's frame PSNR against exact;
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
      train_sp_backends — a LoRA step's loss and gradients with
                ``flash``, then on the one-rank mesh with ``sp_allgather``
                (B1 twice, B2 once a block) and ``ring`` (B1 twice a block;
                its backward fp32 PyTorch math): each loss equal to
                ``flash``'s, the gradients within the kernels' limits;
 18. train_qlora — QLoRA: the same steps as ``train`` over the int8 base
                (flash both ways): per step B1 twice and B2 once per block,
                no B3; the int8 base unchanged; its first loss printed
                beside the exact phase's (same batch, same draws);
      variants — on the same pipeline, 2 steps each at 49x480x720:
                ``generate_i2v`` and ``generate_fun_control`` on an I2V
                transformer (a seeded 32-channel ``patch_embed.proj``),
                ``generate_v2v`` at strength 0.8 on a seeded 49-frame video,
                and ``generate`` with disentangled modulation (seeded adapted
                norm linears, the old ones as ``base_linear``): the clips'
                gates, B1's launches, seconds split into encode, steps and
                decode;
      train_remat — one 5b LoRA step each with remat ``full``, ``dots`` and
                ``seg`` (after an untimed warm-up step) on a 25-frame clip
                (dots keeps every linear's output: ~69 GB at 49 frames):
                seconds, peak memory, launches; the three losses equal;
 19. pretrained — the way users start the system: the full-width pipeline
                written as a bf16 diffusers snapshot into
                ``build/smoke_snapshot/`` (``save_pretrained``; the free
                disk checked first) and a seeded rank-128 LoRA checkpoint
                over the 9 target families into ``build/smoke_lora/``;
                ``from_pretrained`` of the snapshot (timed), its tensors
                equal to the in-memory pipeline's bit for bit, and its
                1-step latents too, with 42 B1 launches; ``load_lora`` in
                merge and then runtime mode (each timed), their 1-step
                latents within ``LORA_MERGE_RUNTIME_TOL``; then, with both
                pipelines freed, ``python3 -m s2v_torch.cli`` in a
                subprocess on the snapshot, the LoRA and a 720x480 PNG
                (written here without PIL) at 49x480x720, 2 steps: exit 0
                and a non-empty clip, with the writer that made it and the
                CLI's B1 launches;
      serve    — ``python3 -m s2v_torch.serve`` in a subprocess on that
                snapshot and LoRA (merged), on the card, then over its socket:
                ping, warmup without an image, a 2-step generate to an mp4,
                the same with DPM, segments of 1 and cfg-skip, a runtime
                ``load_lora`` and a generate, stats, shutdown; every answer
                ``"status": "ok"``; start, request and swap seconds;
      cli_mesh, serve_mesh — the CLI (2 steps at 49x480x720, 84 B1, its
                clip; ``--mesh dp1,sp1,tp1 --text_encoder_device mesh``: the
                DiT and T5 sliced over the model dim) and the daemon (two
                2-step generates answered ok, a shutdown, ``--mesh sp1``)
                under ``python3 -m torch.distributed.run --standalone
                --nproc_per_node 1`` on that snapshot (no LoRA); a
                ``seq_rings`` line then says that no mesh dim above 1 ran on
                the card;
      e2e_mesh, e2e_mesh_int8 — ``generate`` as ``e2e_sp_allgather`` (full
                depth, 84 B1) and as ``e2e_int8`` (cut depth, B3) on the
                one-rank mesh ``dp1,sp1,tp1`` with T5 on the mesh: the
                params sliced over the model dim, the CFG rows split and
                gathered over the data dim; clip and latents held against
                the one-card runs' (bit for bit, else within B1's limits);
      train_lora_mesh — at the cut depth, the LoRA loss and gradients on
                the one-rank ``dp1,tp1`` mesh and with the base sharded over
                the one-rank data dim (``--fsdp_base``'s placements),
                against ``flash`` on one card;
      e2e_fp32 — the pipeline cast to fp32 (``--dtype float32``) at 6
                blocks: ``generate`` at 49x480x720, 2 steps, B1's fp32 kernel
                12 times, the clip finite in [0, 1], its latents against the
                ``chunked`` backend's (PyTorch ops); one step each with
                ``windowed`` (B4 fp32) and ``sp_windowed`` (B6 fp32); then on
                the DiT's int8 linears two steps each with ``flash_int8``
                (B3 fp32) and, on the one-rank seq mesh, ``sp_int8``, finite
                and within the relative RMS the int8 path is held to of the
                exact run's latents;
      train_fp32 — on the same cast: the LoRA loss and adapter gradients
                (``--compute_dtype none``), B1 fp32 12 and B2 fp32 6, against
                ``chunked``'s; then ``windowed`` (B4, B5 fp32) and
                ``sp_windowed`` (B6, B7 fp32);
      train_full_5b_fsdp — full fine-tuning of the 5b DiT under FSDP on
                the one-rank data dim at the deepest cut that fits beside
                the resident pipeline, at most 7 blocks (the depth printed), two micro-steps
                against the unsharded step (losses, params, EMA), peak
                memory and seconds, the sharded train state written and
                read back bit for bit, and the per-rank bytes of the whole
                42-block state at data = 4 and 8, computed from the
                placements;
      train_cli_mesh — the trainer CLI under ``torch.distributed.run``
                with ``--mesh dp1,sp1,tp1 --attention_backend sp_windowed``
                (B6/B7 on the trainer's CLI path) on that snapshot over two
                9-frame 480x720 clips, two micro-steps with sharded train
                states, then a resumed run equal to it bit for bit;
      train_cli — ``python3 -m s2v_torch.train`` in a subprocess on that
                snapshot (LoRA rank 128, no accumulation, cosine warm-up,
                clip 1.0, an encode cache, a train state every step, 2
                steps, a 1-step validation at step 2) over two seeded 49x480x720
                clips written with OpenCV, then a second run resumed from
                ``train_state_1``: load, encode and step seconds, peak
                memory, launches, the files, and the resumed adapters
                against the first run's.  The snapshot and the LoRA are
                deleted after;
      e2e_2b   — with the 5b pipeline released, the CogVideoX-2b pipeline
                (``TransformerConfig.cogvideox_2b()``, T5-XXL and the VAE,
                all fp16, seeded; T5's fp16 embeddings checked finite, else
                T5 on the host in fp32, said so): ``generate_t2v`` and
                ``generate`` at 49x480x720, 2 steps each, 30 fp16 B1 a step;
                one more t2v step under ``torch.profiler``;
      train_2b — the LoRA step of ``train`` on the 2b pipeline (the batch
                carries the sincos table): losses finite, base unchanged,
                fp16 B1 60 and B2 30 a step; B2 held to its plain version
                at step 0's own dO (the last block's attention), with the
                shares of gradients and dS that fp16 flushes;
                both 2b phases add one step each with the opt-ins on fp16
                kernels: ``windowed`` (B4, B5), ``sp_windowed`` on the
                one-rank mesh (B6, B7) and, in ``e2e_2b``, the int8 DiT (B3);
      train_full_2b — full fine-tuning of the 2b DiT at 10 of its 30
                blocks (fp32 master, bf16
                compute, EMA 0.999, accumulation 2, 4 micro-steps): losses,
                seconds, peak memory, the EMA moving on the boundary only,
                and the train state (12 GB at 10 blocks) written and read back bit for bit.
Then the seconds of each phase, the kernels line, the nvidia-smi line, and
the result line.  The 5b pipeline phases share one pipeline; ``pretrained``
empties it, so it, ``serve`` and ``train_cli`` run last of them; the 2b
phases share a pipeline of their own, freed after.  To keep the whole run
under 1,080 s, the earlier opt-in paths run at a cut depth (``DEPTH_CUT``,
each announced by a ``depth_cut`` line): ``e2e_windowed``,
``e2e_sp_windowed``, ``e2e_sp_backends``, ``e2e_int8``, ``e2e_options``,
``train_windowed``, ``train_sp_windowed``, ``train_sp_backends``,
``train_qlora``, ``variants``, ``turbo``, ``e2e_mesh_int8`` and
``train_lora_mesh`` on the first 6 of the 42 blocks, ``e2e_2b`` and
``train_2b`` on the first 10 of 30; their launch counts follow the depth.  Any failed
phase raises: the script exits non-zero and prints no result.  It needs a
CUDA device and the repository beside it.  ``--phases a,b`` runs only those
phases (after the build), for a short check of one part.
"""

import json
import os
import shutil
import struct
import subprocess
import sys
import time
import zlib
from contextlib import nullcontext
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
# the 2b family (CogVideoX-2b: 30 heads of 64, fp16): batched CFG over
# [text 226 | ref 1350 | video 17550] in s2v and [text 226 | video 17550] in
# t2v; the LoRA train step at B=1
SHAPES_2B = {"s2v": (2, 19126, 30, 64), "t2v": (2, 17776, 30, 64)}
TRAIN_SHAPE_2B = (1, 19126, 30, 64)
MODES_2B = ("online", "bounded")
MODES = ("online", "bounded", "bounded_exp2")
MAIN_MODE = "bounded"  # the softmax mode the DiT's attention uses
# H100 SXM peaks (NVIDIA data sheet, dense): bf16 and int8 tensor cores, HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_FP16_FLOPS = 989e12
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
# an fp16 output is no finer than its subnormal spacing: where gradients
# themselves are subnormal (a training step's), both limits allow one such
# step per element (the max error at least this, the relative L2 this much
# more than 1e-2 over the reference's RMS)
FP16_SUBNORMAL_ULP = 2.0 ** -24
# the whole small pipeline in bf16 (weights, activations) against the same
# pipeline with fp32 attention, relative to the largest latent: bf16 rounding
# (2^-8) through 2 blocks x 2 steps, amplified up to 2g - 1 = 3x by the
# guidance mix at g = 2
PIPELINE_REL_TOL = 5e-2
# merge against runtime LoRA, 1-step latents of the full-width bf16 DiT.  The
# JAX package's check of the same thing (tests/test_runtime_lora.py:117-130)
# holds fp32 2-step latents to atol = rtol = 2e-5; scaled to bf16 by the
# ratio of the two formats' unit roundoffs, 2^-8 / 2^-24 = 2^16:
# |merge - runtime| <= 1.31 + 1.31 |runtime|, per element
LORA_MERGE_RUNTIME_TOL = 2e-5 * 2.0 ** 16
# That bound alone would pass a runtime tree that applied nothing.  So the
# relative L2 difference must also stay within this multiple of the bf16
# noise of the same model in the same run (the merged pipeline's latents
# under the plain fp32 attention against B1's: rounding that guidance 6
# multiplies by up to 2g - 1 = 11), and the adapter's own effect (merged
# against base) must exceed that limit
LORA_NOISE_MULT = 2.0
LORA_RANK = 128
SMOKE_SPIECE = REPO / "build" / "smoke_spiece.model"  # the full-width pipeline's tokenizer
# the LoRA factors' std: B·A moves a weight by ~11% of the DiT's 0.02 init
# std, ~60x its bf16 rounding
LORA_STD = 0.02
# the chunked backend's query block (JAX's default), and the most its
# backward's peak may be in fp32 probabilities of one block (the whole S²
# is 18.7 blocks at the training shape)
CHUNKED_BLOCK_Q = 1024
CHUNKED_PEAK_BLOCKS = 8
# The earlier paths that run at a cut depth, to keep the whole smoke under
# 1,110 s with the trainer's and the fp32 phases (PERF.md §4): the 5b opt-in
# paths at the first EARLIER_DEPTH of the DiT's 42 blocks, turbo's two
# 50-step clips at TURBO_DEPTH, the 5b
# full fine-tune under FSDP at most FSDP_DEPTH (the deepest that fit beside
# the pipeline was 14), the 2b LoRA, generate and full fine-tuning paths at
# the first EARLIER_DEPTH_2B of 30, the fp32 pipeline at FP32_DEPTH.  The exact
# generate and train step, pretrained, serve and the kernel phases keep their
# full depth.
EARLIER_DEPTH = 4
EARLIER_DEPTH_2B = 10
TURBO_DEPTH = 3
FSDP_DEPTH = 7
FP32_DEPTH = 6
DEPTH_CUT = {"e2e_windowed": EARLIER_DEPTH, "e2e_sp_windowed": EARLIER_DEPTH, "e2e_int8": EARLIER_DEPTH,
             "e2e_options": EARLIER_DEPTH, "train_windowed": EARLIER_DEPTH, "train_sp_windowed": EARLIER_DEPTH,
             "train_qlora": EARLIER_DEPTH, "e2e_sp_backends": EARLIER_DEPTH, "train_sp_backends": EARLIER_DEPTH,
             "variants": EARLIER_DEPTH, "e2e_2b": EARLIER_DEPTH_2B, "train_2b": EARLIER_DEPTH_2B,
             # the data and model dims' phases: the int8 run and the LoRA
             # gradients at e2e_int8's and train_sp_backends' depth
             "e2e_mesh_int8": EARLIER_DEPTH, "train_lora_mesh": EARLIER_DEPTH, "turbo": TURBO_DEPTH,
             "train_full_5b_fsdp": FSDP_DEPTH, "train_full_2b": EARLIER_DEPTH_2B,
             # the fp32 pipeline (--dtype float32): its DiT cast at this depth
             "e2e_fp32": FP32_DEPTH, "train_fp32": FP32_DEPTH}
# the trainer CLI's resumed run against the uninterrupted one at step 2: the
# adapters' max difference relative to their largest entry (the same draws,
# batches and deterministic kernels give 0; the limit leaves room for a
# cuBLAS heuristic that picks another kernel in a new process)
RESUME_REL_TOL = 1e-3


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


def queued_ms(fn, iters):
    """:func:`cuda_ms` with the launches queued behind a device sleep (≈ 25
    ms), so the events time the device's work even where a call's host
    work outlasts its kernel."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_build():
    from s2v_torch.kernels.adaln import SOURCE as ADALN_SRC
    from s2v_torch.kernels.attention_f32 import BWD_SOURCE as F32_BWD_SRC
    from s2v_torch.kernels.attention_f32 import SOURCE as F32_SRC
    from s2v_torch.kernels.banded_attention import SOURCE as BANDED_SRC
    from s2v_torch.kernels.banded_attention_bwd import SOURCE as BANDED_BWD_SRC
    from s2v_torch.kernels.flash_attention import SOURCE as FLASH_SRC
    from s2v_torch.kernels.flash_attention_bwd import SOURCE as FLASH_BWD_SRC
    from s2v_torch.kernels.int8_attention import SOURCE as INT8_SRC
    from s2v_torch.kernels.qk_norm_rope import SOURCE as QK_SRC
    from s2v_torch.utils import native_build
    from s2v_torch.utils.sp_native import SOURCE as SP_SRC

    t0 = time.perf_counter()
    kernels = (FLASH_SRC, FLASH_BWD_SRC, BANDED_SRC, BANDED_BWD_SRC, INT8_SRC, F32_SRC, F32_BWD_SRC, QK_SRC,
               ADALN_SRC)
    results = native_build.build([*kernels, SP_SRC])
    # per kernel: its registers, spills and shared memory
    ptxas = {src.stem: [ln.strip() for ln in results[src.stem]["log"].splitlines()
                        if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
             for src in kernels}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_source_s": {k: v["seconds"] for k, v in results.items()}, "ptxas": ptxas})


def _qkv(b, sq, skv, h, seed, dev, dtype=None):
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    return tuple(torch.randn(b, s, h, 64, device=dev, generator=g).to(dtype or torch.bfloat16) for s in (sq, skv, skv))


def _agreement(o, o_ref, what, floor=0.0):
    """Hold a kernel output against its plain version with the limits
    above, each widened by an output step of ``floor`` per element (the
    max error at least ``floor``, the relative L2 ``floor`` / RMS more);
    returns the numbers the JSON lines print."""
    o_ref = o_ref.float()
    diff = o.float() - o_ref
    ref_max = o_ref.abs().max().item()
    ref_rms = o_ref.square().mean().sqrt().item()
    stats = {"max_abs_err": diff.abs().max().item(), "max_abs_tol": max(OUT_MAX_REL * ref_max, floor),
             "rel_l2": (diff.norm() / o_ref.norm()).item(), "rel_l2_tol": OUT_L2_REL + floor / ref_rms,
             "ref_max": ref_max, "ref_rms": ref_rms}
    if not (stats["max_abs_err"] <= stats["max_abs_tol"] and stats["rel_l2"] < stats["rel_l2_tol"]):
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
    from s2v_torch.kernels import native
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
        before = native.launches("flash_attention_rerun")
        o = flash_attention(q, k, v, softmax_mode=mode)
        if native.launches("flash_attention_rerun") != before + 1:
            raise AssertionError(f"bounded re-run not taken ({mode})")
        o_ref = flash_attention_reference(q, k, v, softmax_mode="online")
        reruns[mode] = {"reruns": native.launches("flash_attention_rerun") - before,
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
              "tflops": flops / main[MAIN_MODE]["ms"] / 1e9, "reruns": native.launches("flash_attention_rerun"),
              "smem_bytes": fa_module.LIB.entry("s2v_flash_attention_fwd_smem_bytes")()}
    emit(result)
    return result


def _bwd_inputs(b, sq, skv, h, seed, dev, layer_norm=False, dtype=None):
    """q, k, v, o, lse (B1 in the train path's softmax mode) and a seeded dO."""
    import torch
    import torch.nn.functional as F

    from s2v_torch.kernels.flash_attention import flash_attention

    dtype = dtype or torch.bfloat16
    q, k, v = _qkv(b, sq, skv, h, seed, dev, dtype)
    if layer_norm:
        q = F.layer_norm(q.float(), (64,)).to(dtype)
        k = F.layer_norm(k.float(), (64,)).to(dtype)
    o, lse = flash_attention(q, k, v, return_lse=True, softmax_mode=MAIN_MODE)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    do = torch.randn(q.shape, device=dev, generator=g).to(dtype)
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
              "smem_bytes": fab.LIB.entry("s2v_flash_attention_bwd_smem_bytes")(),
              "b1_with_lse_ms": b1_ms, "b1_with_lse_tflops": 4 * b * h * s * s * d / b1_ms / 1e9}
    emit(result)
    return result


def phase_kernel_fp16(dev):
    """Kernel B1 in fp16 (the 2b family) against its plain version (fp32
    from the same fp16 values), held to the bf16 limits: small ragged and
    masked shapes in every mode, then the 2b shapes of s2v and t2v in
    both softmax modes, each timed beside its bound at 989 TFLOP/s dense
    fp16, the plain version and one fp16 ``F.scaled_dot_product_attention``
    call (a yardstick only)."""
    import torch
    import torch.nn.functional as F

    from s2v_torch.kernels import native
    from s2v_torch.kernels.flash_attention import flash_attention, flash_attention_reference

    fp16 = torch.float16
    small = []
    for mode in MODES:
        for (b, sq, skv, h, masked) in [(2, 200, 200, 3, False), (1, 77, 333, 2, True), (1, 130, 40, 2, False)]:
            q, k, v = _qkv(b, sq, skv, h, sq + skv, dev, fp16)
            mask = None
            if masked:
                mask = torch.zeros(skv, dtype=torch.bool, device=dev)
                mask[5:40] = True
            before = native.launches("flash_attention_rerun")
            stats = _compare(q, k, v, mode, mask)
            small.append({"mode": mode, "q": [b, sq, h, 64], "skv": skv, "masked": masked,
                          "reruns": native.launches("flash_attention_rerun") - before, **stats})
    emit({"phase": "kernel_fp16_small", "cases": small})

    # one q row scaled x4 puts M0 ~40 nats above every other row's largest
    # logit: rounded to fp16 there, their P would flush to zero, so the
    # kernel flags those rows and the guard re-runs the call online
    far = {}
    for mode in ("bounded", "bounded_exp2"):
        q, k, v = _qkv(1, 300, 300, 2, 31, dev, fp16)
        q[:, 0] *= 4
        before = native.launches("flash_attention_rerun")
        stats = _compare(q, k, v, mode)
        if native.launches("flash_attention_rerun") != before + 1:
            raise AssertionError(f"flash_attention fp16 [{mode}]: rows far below M0 did not re-run online")
        far[mode] = {"reruns": native.launches("flash_attention_rerun") - before, **stats}
    emit({"phase": "kernel_fp16_far_rows", "cases": far})

    shapes = {}
    for name, (b, s, h, d) in SHAPES_2B.items():
        q, k, v = _qkv(b, s, s, h, 17, dev, fp16)
        q = F.layer_norm(q.float(), (d,)).to(fp16)
        k = F.layer_norm(k.float(), (d,)).to(fp16)
        modes = {}
        for mode in MODES_2B:
            before = native.launches("flash_attention_rerun")
            stats = _compare(q, k, v, mode)
            if native.launches("flash_attention_rerun") != before:  # the time below would be two launches
                raise AssertionError(f"flash_attention fp16 [{mode}] at the {name} shape re-ran online")
            flash_attention(q, k, v, softmax_mode=mode)  # warm-up
            modes[mode] = {**stats, "ms": cuda_ms(lambda: flash_attention(q, k, v, softmax_mode=mode), 10)}
        plain_ms = cuda_ms(lambda: flash_attention_reference(q, k, v, softmax_mode=MAIN_MODE), 2)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        F.scaled_dot_product_attention(qt, kt, vt)
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt), 10)
        flops = 4 * b * h * s * s * d
        nbytes = 4 * b * s * h * d * 2 + b * h * s * 4
        bound_ms = max(flops / PEAK_FP16_FLOPS, nbytes / PEAK_BYTES_PER_S) * 1e3
        bound_by = "operations" if flops / PEAK_FP16_FLOPS >= nbytes / PEAK_BYTES_PER_S else "bytes"
        for mode in MODES_2B:
            modes[mode]["tflops"] = flops / modes[mode]["ms"] / 1e9
        shapes[name] = {"shape": [b, s, h, d], "modes": modes, "plain_ms": plain_ms, "library_ms": library_ms,
                        "bound_ms": bound_ms, "bound_by": bound_by}
        del q, k, v, qt, kt, vt
    result = {"phase": "kernel_fp16_main", "dtype": "float16", "shapes": shapes, "far_rows": far}
    emit(result)
    return result


def phase_kernel_bwd_fp16(dev):
    """Kernel B2 in fp16 against its plain version and the emulation of its
    schedule (P and dS rounded to fp16): small ragged shapes, then the 2b
    training shape B=1, S=19,126, H=30, where two launches must agree bit
    for bit; timed beside its bound, the plain version and the backward of
    one fp16 SDPA call (a yardstick only)."""
    import torch
    import torch.nn.functional as F

    from s2v_torch.kernels.flash_attention_bwd import flash_attention_bwd, flash_attention_bwd_reference

    fp16 = torch.float16
    small = []
    for (b, sq, skv, h) in [(2, 200, 200, 3), (1, 77, 333, 2), (1, 130, 40, 2)]:
        small.append({"q": [b, sq, h, 64], "skv": skv,
                      **_compare_bwd(*_bwd_inputs(b, sq, skv, h, sq + skv, dev, dtype=fp16))})
    emit({"phase": "kernel_bwd_fp16_small", "cases": small})

    b, s, h, d = TRAIN_SHAPE_2B
    q, k, v, o, lse, do = _bwd_inputs(b, s, s, h, 19, dev, layer_norm=True, dtype=fp16)
    stats = _compare_bwd(q, k, v, o, lse, do)
    first = flash_attention_bwd(q, k, v, o, lse, do)
    second = flash_attention_bwd(q, k, v, o, lse, do)
    deterministic = {name: bool(torch.equal(a, c)) for name, a, c in zip(("dq", "dk", "dv"), first, second)}
    if not all(deterministic.values()):
        raise AssertionError(f"flash_attention_bwd fp16: two launches on the same inputs differ: {deterministic}")
    finite = all(bool(torch.isfinite(x).all()) for x in first)
    if not finite:
        raise AssertionError("flash_attention_bwd fp16: a gradient is not finite")
    del first, second
    # dO at 2^-10 of unit normal: over 19,126 keys dS then sits near fp16's
    # flush point (2^-25), where rounding it unscaled moves dq and dk by a
    # few percent
    small_do = _bwd_at_small_do(q, k, v, o, lse, (do.float() * 2.0 ** -10).to(fp16),
                                "flash_attention_bwd fp16 at dO 2^-10")
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
    flops = 10 * b * h * s * s * d
    nbytes = 8 * b * s * h * d * 2 + b * h * s * 4
    bound_ms = max(flops / PEAK_FP16_FLOPS, nbytes / PEAK_BYTES_PER_S) * 1e3
    bound_by = "operations" if flops / PEAK_FP16_FLOPS >= nbytes / PEAK_BYTES_PER_S else "bytes"
    result = {"phase": "kernel_bwd_fp16_main", "dtype": "float16", "shape": list(TRAIN_SHAPE_2B), "grads": stats,
              "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by,
              "tflops": flops / ms / 1e9, "parts_ms": parts_ms, "deterministic": deterministic,
              "small_do": small_do}
    emit(result)
    return result


def _bwd_at_small_do(q, k, v, o, lse, do, what):
    """fp16 B2 against its plain version at a small dO, held to the kernel
    limits (the max error at least one fp16 subnormal step), with what fp16
    does there: per gradient the share of entries the kernel leaves at zero
    where the plain version's fp16 output is not, and the plain version's
    own share of zeros; and over head 0 of the first batch row, the share of
    the fp32 dS that is nonzero, and of that, the share below fp16's flush
    point (2^-25) and below its normal range (2^-14), unscaled and scaled by
    the kernels' 2^e."""
    import torch

    from s2v_torch.kernels.flash_attention_bwd import (
        ds_exponent,
        flash_attention_bwd,
        flash_attention_bwd_reference,
        row_delta,
    )

    got = flash_attention_bwd(q, k, v, o, lse, do)
    want = flash_attention_bwd_reference(q, k, v, o, lse, do)
    e = int(ds_exponent(v, do))
    out = {"do_max_abs": do.float().abs().max().item(), "do_rms": do.float().square().mean().sqrt().item(),
           "ds_exp": e}
    for name, a, r in zip(("dq", "dk", "dv"), got, want):
        out[name] = {**_agreement_or_zero(a, r, f"{what} {name}", FP16_SUBNORMAL_ULP),
                     "zero_share": ((a == 0) & (r != 0)).float().mean().item(),
                     "ref_zero_share": (r == 0).float().mean().item()}
    del got, want
    qh, kh, vh, gh = (x[0, :, 0].float() for x in (q, k, v, do))
    delta = row_delta(o, do)[0, 0]
    tallies = torch.zeros(6, dtype=torch.float64, device=q.device)  # all, nonzero, 4 shares' counts
    ds_max = 0.0
    for r0 in range(0, qh.shape[0], 2048):
        p = torch.exp(qh[r0:r0 + 2048] @ kh.T * q.shape[-1] ** -0.5 - lse[0, 0, r0:r0 + 2048, None])
        ds = (p * (gh[r0:r0 + 2048] @ vh.T - delta[r0:r0 + 2048, None])).abs()
        nz = ds > 0
        ds_max = max(ds_max, ds.max().item())
        tallies += torch.stack([torch.tensor(float(ds.numel()), device=q.device), nz.sum(),
                                (nz & (ds < 2.0 ** -25)).sum(), (nz & (ds < 2.0 ** -14)).sum(),
                                (nz & (ds * 2.0 ** e < 2.0 ** -25)).sum(),
                                (nz & (ds * 2.0 ** e < 2.0 ** -14)).sum()]).double()
    n_all, n_nz, *counts = tallies.tolist()
    share = lambda c: c / n_nz if n_nz else None  # noqa: E731
    out["ds_head0"] = {"max_abs": ds_max, "nonzero_share": n_nz / n_all, "flush_share": share(counts[0]),
                       "subnormal_share": share(counts[1]), "flush_share_scaled": share(counts[2]),
                       "subnormal_share_scaled": share(counts[3])}
    return out


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


def _ln_qkv(b, s, h, seed, dev, dtype=None):
    """q, k, v at the DiT's scale: q/k LayerNormed over d, as after qk-norm."""
    import torch
    import torch.nn.functional as F

    dtype = dtype or torch.bfloat16
    q, k, v = _qkv(b, s, s, h, seed, dev, dtype)
    return F.layer_norm(q.float(), (64,)).to(dtype), F.layer_norm(k.float(), (64,)).to(dtype), v


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
              "smem_bytes": ba.LIB.entry("s2v_banded_attention_fwd_smem_bytes")()}
    emit(result)
    return result


def _banded_bwd_inputs(b, h, s, band, seed, dev, layer_norm=False, dtype=None):
    """q, k, v, o, lse (B4 with lse) and a seeded dO."""
    import torch

    from s2v_torch.kernels.banded_attention import banded_flash_attention

    q, k, v = _ln_qkv(b, s, h, seed, dev, dtype) if layer_norm else _qkv(b, s, s, h, seed, dev, dtype)
    o, lse = banded_flash_attention(q, k, v, *band, return_lse=True)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    do = torch.randn(q.shape, device=dev, generator=g).to(q.dtype)
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
              "smem_bytes": bab.LIB.entry("s2v_banded_attention_bwd_smem_bytes")()}
    emit(result)
    return result


SP_RINGS = (1, 2, 4)  # the seq rings whose shards the SP kernel phases launch, every offset of each


def _agreement_or_zero(o, o_ref, what, floor=0.0):
    """:func:`_agreement`, except that an all-zero reference (a dk/dv partial
    of a shard that no query of the band reaches, or a gradient that fp16
    flushes) needs an output no larger than ``floor``."""
    if not o_ref.any():
        err = o.float().abs().max().item()
        if err > floor:
            raise AssertionError(f"{what}: reference is zero, kernel max |x| {err}")
        return {"max_abs_err": 0.0, "max_abs_tol": 0.0, "rel_l2": 0.0, "rel_l2_tol": OUT_L2_REL, "ref_max": 0.0,
                "ref_rms": 0.0}
    return _agreement(o, o_ref, what, floor)


def _shard_rows(x, geo, f_loc, off):
    """A shard's video rows of ``x``: frames ``off .. off + f_loc - 1``, zero
    past the clip (the dummy frames), as the SP wrapper takes them."""
    import torch.nn.functional as F

    tpf = geo.tokens_per_frame
    rows = x[:, geo.global_len + off * tpf:geo.global_len + (off + f_loc) * tpf]
    return F.pad(rows, (0, 0, 0, 0, 0, f_loc * tpf - rows.shape[1]))


def _compact(stats):
    """The numbers of a small case, for a short JSON line."""
    keys = ("max_abs_err", "max_abs_tol", "rel_l2", "lse_err")
    return {k: stats[k] for k in keys if k in stats}


def phase_kernel_banded_local(dev):
    """Kernel B6 (one SP shard of video-query frames at a runtime frame
    offset, against the full K/V) against its plain version: the small
    geometries at every offset of a 2- and a 4-rank ring, dummy frames
    included (a ring with more ranks than frames runs in phase
    ring_past_frames); then the main band (B=2) for P = 1, 2, 4:
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

    small, past_frames = [], []
    for (b, h, g, tpf, f, w) in BANDED_SMALL:
        geo = band_geometry(g + f * tpf, g, tpf, w)
        q, k, v = _qkv(b, g + f * tpf, g + f * tpf, h, g + tpf + f + 3, dev)
        for ring in (2, 4):
            f_pad, f_loc = ring_shards(f, ring)
            if ring > f:
                past_frames.append([g, tpf, f, w, ring])
                continue  # rings past the frame count: phase ring_past_frames
            for r in range(ring):
                stats, _, _ = compare(_shard_rows(q, geo, f_loc, r * f_loc), k, v, geo, r * f_loc, schedule=True)
                small.append({"band": [b, h, g, tpf, f, w], "ring": ring, "offset": r * f_loc,
                              "dummy_frames": f_loc - geo.shard(r * f_loc, f_loc).real_frames(), **_compact(stats),
                              "schedule_share": stats["schedule_max_abs_err"] / stats["schedule_max_abs_tol"]})
    emit({"phase": "kernel_banded_local_small", "cases": small, "rings_past_frames": past_frames})

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
                continue  # rings past the frame count: phase ring_past_frames
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


# the small cases of the fp16 banded phases (B, H, G, tpf, F, w): clamped
# windows, w = 0, a window wider than the clip, the main shape's remainders
# mod 128, a frame of three query tiles
BANDED_SMALL_FP16 = [(2, 3, 24, 20, 5, 1), (1, 2, 24, 20, 4, 0), (1, 2, 50, 40, 5, 9), (1, 2, 168, 198, 5, 2),
                     (1, 2, 40, 384, 3, 1)]
# the 2b family's windowed shape: [text 226 | ref 1,350] global, 13 frames, w = 2, at B=2 (batched CFG)
MAIN_SHAPE_2B = SHAPES_2B["s2v"]


def _fp16_bound(flops, nbytes):
    """(bound_ms, bound_by) at the fp16 tensor-core peak (989 TFLOP/s dense, bf16's)."""
    t_ops, t_bytes = flops / PEAK_FP16_FLOPS, nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def _masked_sdpa_ms(q_rows, k, v, rows, geo, grad=None):
    """One fp16 ``F.scaled_dot_product_attention`` call (its backward when
    ``grad``, dO of the rows, is given) over the query rows ``rows`` with
    the band as a boolean mask: the library yardstick of the fp16 banded
    phases (the port never calls it)."""
    import torch
    import torch.nn.functional as F

    from s2v_torch.kernels.banded_attention import band_mask

    s = k.shape[1]

    def setup(shape):
        bb, hh = shape
        qt, kt, vt = (x[:bb, :, :hh].transpose(1, 2) for x in (q_rows, k, v))
        mask = band_mask(geo, rows, s)
        if grad is None:
            return lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
        qt, kt, vt = (x.detach().requires_grad_() for x in (qt, kt, vt))
        out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
        gt = grad[:bb, :, :hh].transpose(1, 2)
        return lambda: torch.autograd.grad(out, (qt, kt, vt), gt, retain_graph=True)

    b, _, h, _ = q_rows.shape
    return _library_ms("fp16 masked SDPA" + (" backward" if grad is not None else ""), setup,
                       [(b, h), (1, h), (1, h // 2)])


def phase_kernel_banded_fp16(dev):
    """Kernel B4 in fp16 (the 2b family with ``--attention_backend
    windowed``; the global queries through fp16 B1) against its plain
    version and the emulation of its schedule (P rounded to fp16): small
    geometries, then the 2b shape B=2, S=19,126, H=30 with the 5b band,
    timed over 10 launches beside its bound at 989 TFLOP/s dense fp16, the
    plain version and one fp16 SDPA call with the band as a boolean mask
    over the video queries (a yardstick only)."""
    import torch

    from s2v_torch.kernels import native
    from s2v_torch.kernels.banded_attention import (
        band_geometry,
        banded_flash_attention,
        banded_flash_attention_reference,
        launch_banded,
    )

    fp16 = torch.float16
    small = []
    for (b, h, g, tpf, f, w) in BANDED_SMALL_FP16:
        q, k, v = _qkv(b, g + f * tpf, g + f * tpf, h, g + tpf + f + 40, dev, fp16)
        stats = _compare_banded(q, k, v, (g, tpf, w), schedule=True)
        small.append({"band": [b, h, g, tpf, f, w], **_compact(stats),
                      "schedule_share": stats["schedule_max_abs_err"] / stats["schedule_max_abs_tol"]})
    emit({"phase": "kernel_banded_fp16_small", "cases": small})

    b, s, h, d = MAIN_SHAPE_2B
    q, k, v = _ln_qkv(b, s, h, 47, dev, fp16)
    geo = band_geometry(s, *BAND)
    before = native.launches("banded_flash_attention", "float16")
    stats = _compare_banded(q, k, v, BAND)
    if native.launches("banded_flash_attention", "float16") != before + 1:
        raise AssertionError("banded_flash_attention fp16: the fp16 entry did not launch")
    banded_flash_attention(q, k, v, *BAND)  # warm-up
    ms = cuda_ms(lambda: banded_flash_attention(q, k, v, *BAND), 10)
    o = torch.empty_like(q)
    video_ms = cuda_ms(lambda: launch_banded(q, k, v, o, None, geo, d ** -0.5), 10)
    del o
    plain_ms = cuda_ms(lambda: banded_flash_attention_reference(q, k, v, *BAND), 2)
    rows = torch.arange(geo.global_len, s, device=dev)
    library_ms, library_shape, library_failed = _masked_sdpa_ms(q[:, geo.global_len:], k, v, rows, geo)
    pairs_vid, pairs_glob = geo.pairs()
    flops_vid, flops_glob = 4 * b * h * d * pairs_vid, 4 * b * h * d * pairs_glob
    bound_ms, bound_by = _fp16_bound(flops_vid + flops_glob, 4 * b * s * h * d * 2)
    s_vid = s - geo.global_len
    video_bound_ms, _ = _fp16_bound(flops_vid, (2 * s_vid + 2 * s) * b * h * d * 2)
    result = {"phase": "kernel_banded_fp16_main", "dtype": "float16", "shape": list(MAIN_SHAPE_2B),
              "band": list(BAND), **stats, "ms": ms, "video_launch_ms": video_ms, "plain_ms": plain_ms,
              "library_ms": library_ms, "library_shape": library_shape, "library_not_run": library_failed,
              "bound_ms": bound_ms, "bound_by": bound_by, "video_bound_ms": video_bound_ms,
              "video_tflops": flops_vid / video_ms / 1e9,
              "small_worst_schedule_share": max(c["schedule_share"] for c in small)}
    emit(result)
    return result


def phase_kernel_banded_bwd_fp16(dev):
    """Kernel B5 in fp16 (the windowed 2b train step; the global queries
    through fp16 B2) against its plain version and the emulation of its
    schedule (P and dS rounded to fp16, dS scaled by 2^e first): small
    geometries, then the 2b training shape B=1, S=19,126, H=30, where two
    launches must agree bit for bit, and at dO 2^-10 of it (where fp16
    would flush an unscaled dS); timed beside its bound, the plain version
    and the backward of one fp16 masked SDPA call (a yardstick only)."""
    import torch

    from s2v_torch.kernels import banded_attention_bwd as bab
    from s2v_torch.kernels import native
    from s2v_torch.kernels.banded_attention import band_geometry
    from s2v_torch.kernels.banded_attention_bwd import (
        band_ds_exponent,
        banded_flash_attention_bwd,
        banded_flash_attention_bwd_reference,
        launch_banded_bwd,
    )

    fp16 = torch.float16
    small = []
    for (b, h, g, tpf, f, w) in BANDED_SMALL_FP16:
        inputs = _banded_bwd_inputs(b, h, g + f * tpf, (g, tpf, w), g + tpf + f + 50, dev, dtype=fp16)
        stats = _compare_banded_bwd(*inputs, (g, tpf, w), schedule=True)
        small.append({"band": [b, h, g, tpf, f, w], **{n: _compact(v) for n, v in stats.items()},
                      "schedule_share": max(v["schedule_max_abs_err"] / v["schedule_max_abs_tol"]
                                            for v in stats.values())})
    emit({"phase": "kernel_banded_bwd_fp16_small", "cases": small})

    b, s, h, d = TRAIN_SHAPE_2B
    geo = band_geometry(s, *BAND)
    q, k, v, o, lse, do = _banded_bwd_inputs(b, h, s, BAND, 51, dev, layer_norm=True, dtype=fp16)
    before = native.launches("banded_flash_attention_bwd", "float16")
    stats = _compare_banded_bwd(q, k, v, o, lse, do, BAND)
    if native.launches("banded_flash_attention_bwd", "float16") != before + 1:
        raise AssertionError("banded_flash_attention_bwd fp16: the fp16 entry did not launch")
    deterministic = _determinism(banded_flash_attention_bwd, (q, k, v, o, lse, do, *BAND),
                                 "banded_flash_attention_bwd fp16")
    # dO 2^-10 of unit normal: unscaled, most of the fp32 dS would flush in fp16
    small_do = (do.float() * 2.0 ** -10).to(fp16)
    got = banded_flash_attention_bwd(q, k, v, o, lse, small_do, *BAND)
    want = banded_flash_attention_bwd_reference(q, k, v, o, lse, small_do, *BAND)
    at_small_do = {n: _compact(_agreement_or_zero(a, r, f"banded_flash_attention_bwd fp16 at dO 2^-10 {n}",
                                                  FP16_SUBNORMAL_ULP))
                   for n, a, r in zip(("dq", "dk", "dv"), got, want)}
    at_small_do["ds_exp"] = int(band_ds_exponent(v, small_do[:, geo.global_len:], geo))
    del got, want, small_do
    banded_flash_attention_bwd(q, k, v, o, lse, do, *BAND)  # warm-up
    ms = cuda_ms(lambda: banded_flash_attention_bwd(q, k, v, o, lse, do, *BAND), 10)
    grads = [torch.empty_like(q) for _ in range(3)]
    rows = geo.n_frames * geo.tokens_per_frame
    ws = bab.banded_bwd_workspace(q, rows)
    video_ms = cuda_ms(lambda: launch_banded_bwd(q, k, v, o, do, lse, *grads, geo, d ** -0.5, ws), 10)
    parts_ms = _banded_bwd_parts_ms(
        lambda ws_, parts: launch_banded_bwd(q, k, v, o, do, lse, *grads, geo, d ** -0.5, ws_, parts), rows, q)
    del grads, ws
    plain_ms = cuda_ms(lambda: banded_flash_attention_bwd_reference(q, k, v, o, lse, do, *BAND), 2)
    library_ms, library_shape, library_failed = _masked_sdpa_ms(
        q[:, geo.global_len:], k, v, torch.arange(geo.global_len, s, device=dev), geo, grad=do[:, geo.global_len:])
    pairs_vid, pairs_glob = geo.pairs()
    flops_vid, flops_glob = 10 * b * h * d * pairs_vid, 10 * b * h * d * pairs_glob
    bound_ms, bound_by = _fp16_bound(flops_vid + flops_glob, 8 * b * s * h * d * 2 + b * h * s * 4)
    s_vid = s - geo.global_len
    video_bound_ms, _ = _fp16_bound(flops_vid, (3 * s_vid + 4 * s) * b * h * d * 2 + 2 * b * h * s_vid * 4)
    result = {"phase": "kernel_banded_bwd_fp16_main", "dtype": "float16", "shape": list(TRAIN_SHAPE_2B),
              "band": list(BAND), "grads": stats, "at_small_do": at_small_do, "deterministic": deterministic,
              "ms": ms, "video_launch_ms": video_ms, "video_parts_ms": parts_ms, "plain_ms": plain_ms,
              "library_ms": library_ms, "library_shape": library_shape, "library_not_run": library_failed,
              "bound_ms": bound_ms, "bound_by": bound_by, "video_bound_ms": video_bound_ms,
              "video_tflops": flops_vid / video_ms / 1e9,
              "small_worst_schedule_share": max(c["schedule_share"] for c in small)}
    emit(result)
    return result


def _fp16_local_cases(dev, fn):
    """``fn(q_loc, k, v, geo, off, seed)`` at every offset of a 2-rank ring
    over the small fp16 geometries (dummy frames included)."""
    import torch

    from s2v_torch.kernels.banded_attention import band_geometry, ring_shards

    out = []
    for (b, h, g, tpf, f, w) in BANDED_SMALL_FP16:
        geo = band_geometry(g + f * tpf, g, tpf, w)
        q, k, v = _qkv(b, g + f * tpf, g + f * tpf, h, g + tpf + f + 60, dev, torch.float16)
        _, f_loc = ring_shards(f, 2)
        for r in range(2):
            out.append({"band": [b, h, g, tpf, f, w], "offset": r * f_loc,
                        **fn(_shard_rows(q, geo, f_loc, r * f_loc), k, v, geo, r * f_loc, g + tpf + f + r)})
    return out


def phase_kernel_banded_local_fp16(dev):
    """Kernel B6 in fp16 against its plain version and the emulation of its
    schedule: the small geometries at every offset of a 2-rank ring; then
    one rank's shard at the 2b shape (q the 17,550 video rows of B=2, H=30,
    K/V all 19,126), stitched against fp16 B4's rows and timed beside its
    bound, the plain version and one fp16 masked SDPA call (a yardstick)."""
    import torch

    from s2v_torch.kernels import native
    from s2v_torch.kernels.banded_attention import (
        band_geometry,
        banded_flash_attention,
        banded_flash_attention_blocked,
        banded_flash_attention_local,
        banded_flash_attention_local_reference,
    )

    def compare(q_loc, k, v, geo, off, _seed, schedule=True):
        band = (geo.global_len, geo.tokens_per_frame, geo.window)
        o = banded_flash_attention_local(q_loc, k, v, *band, off, geo.n_frames)
        what = f"banded_flash_attention_local fp16 {tuple(q_loc.shape)} band {band} offset {off}"
        stats = _agreement(o, banded_flash_attention_local_reference(q_loc, k, v, *band, off, geo.n_frames), what)
        if schedule:
            stats.update(_schedule_stats(o, banded_flash_attention_blocked(
                q_loc, k, v, *band, frame_offset=off, n_frames_total=geo.n_frames), what))
        return {**_compact(stats), **{k_: stats[k_] for k_ in stats if k_.startswith("schedule")}}

    small = _fp16_local_cases(dev, compare)
    emit({"phase": "kernel_banded_local_fp16_small", "cases": small})

    b, s, h, d = MAIN_SHAPE_2B
    q, k, v = _ln_qkv(b, s, h, 61, dev, torch.float16)
    geo = band_geometry(s, *BAND)
    q_loc = q[:, geo.global_len:]
    before = native.launches("banded_flash_attention_local", "float16")
    stats = compare(q_loc, k, v, geo, 0, 0, schedule=False)
    if native.launches("banded_flash_attention_local", "float16") != before + 1:
        raise AssertionError("banded_flash_attention_local fp16: the fp16 entry did not launch")
    o4 = banded_flash_attention(q, k, v, *BAND)[:, geo.global_len:]
    o6 = banded_flash_attention_local(q_loc, k, v, *BAND, 0, geo.n_frames)
    stitched = {"bitwise_equal_to_b4": bool(torch.equal(o6, o4)), **_compact(_agreement(o6, o4, "fp16 B6 vs B4"))}
    del o4, o6
    banded_flash_attention_local(q_loc, k, v, *BAND, 0, geo.n_frames)  # warm-up
    ms = cuda_ms(lambda: banded_flash_attention_local(q_loc, k, v, *BAND, 0, geo.n_frames), 10)
    plain_ms = cuda_ms(lambda: banded_flash_attention_local_reference(q_loc, k, v, *BAND, 0, geo.n_frames), 2)
    library_ms, library_shape, library_failed = _masked_sdpa_ms(
        q_loc, k, v, torch.arange(geo.global_len, s, device=dev), geo)
    flops = 4 * b * h * d * geo.shard_pairs()
    sq = q_loc.shape[1]
    bound_ms, bound_by = _fp16_bound(flops, (2 * sq + 2 * s) * b * h * d * 2)
    result = {"phase": "kernel_banded_local_fp16_main", "dtype": "float16", "shape": list(MAIN_SHAPE_2B),
              "q_shape": [b, sq, h, d], "band": list(BAND), **stats, "stitched_vs_b4": stitched, "ms": ms,
              "plain_ms": plain_ms, "library_ms": library_ms, "library_shape": library_shape,
              "library_not_run": library_failed, "bound_ms": bound_ms, "bound_by": bound_by,
              "tflops": flops / ms / 1e9,
              "small_worst_schedule_share": max(c["schedule_max_abs_err"] / c["schedule_max_abs_tol"]
                                                for c in small)}
    emit(result)
    return result


def phase_kernel_banded_local_bwd_fp16(dev):
    """Kernel B7 in fp16 against its plain version and the emulation of its
    schedule: the small geometries at every offset of a 2-rank ring; then
    one rank's shard at the 2b training shape (B=1, H=30), two launches
    bit for bit, its dq and partials against fp16 B5's, timed beside its
    bound, the plain version and the backward of one fp16 masked SDPA call."""
    import torch

    from s2v_torch.kernels import native
    from s2v_torch.kernels.banded_attention import band_geometry, banded_flash_attention_local
    from s2v_torch.kernels.banded_attention_bwd import (
        banded_flash_attention_bwd,
        banded_flash_attention_bwd_blocked,
        banded_flash_attention_local_bwd,
        banded_flash_attention_local_bwd_reference,
    )

    def compare(q_loc, k, v, geo, off, seed, schedule=True):
        band = (geo.global_len, geo.tokens_per_frame, geo.window)
        o, lse = banded_flash_attention_local(q_loc, k, v, *band, off, geo.n_frames, return_lse=True)
        do = torch.randn(q_loc.shape, device=dev, generator=torch.Generator(device=dev).manual_seed(seed)).half()
        do[:, geo.shard(off, q_loc.shape[1] // geo.tokens_per_frame).real_frames() * geo.tokens_per_frame:] = 0
        args = (q_loc, k, v, o, lse, do, *band, off, geo.n_frames)
        got = banded_flash_attention_local_bwd(*args)
        want = banded_flash_attention_local_bwd_reference(*args)
        what = f"banded_flash_attention_local_bwd fp16 {tuple(q_loc.shape)} band {band} offset {off}"
        out = {n: _compact(_agreement_or_zero(a, r, f"{what} {n}")) for n, a, r in zip(("dq", "dk", "dv"), got, want)}
        if schedule:
            emulated = banded_flash_attention_bwd_blocked(q_loc, k, v, o, lse, do, *band, frame_offset=off,
                                                          n_frames_total=geo.n_frames)
            out["schedule_share"] = max(
                (_agreement(a, e, f"{what} {n} against the emulation")["max_abs_err"]
                 / max(OUT_MAX_REL * e.float().abs().max().item(), 1e-30)) if e.any() else 0.0
                for n, a, e in zip(("dq", "dk", "dv"), got, emulated))
        return out

    small = _fp16_local_cases(dev, compare)
    emit({"phase": "kernel_banded_local_bwd_fp16_small", "cases": small})

    b, s, h, d = TRAIN_SHAPE_2B
    geo = band_geometry(s, *BAND)
    q, k, v, o, lse, do = _banded_bwd_inputs(b, h, s, BAND, 71, dev, layer_norm=True, dtype=torch.float16)
    g_len = geo.global_len
    args = (q[:, g_len:], k, v, o[:, g_len:], lse[..., g_len:].contiguous(), do[:, g_len:], *BAND, 0, geo.n_frames)
    before = native.launches("banded_flash_attention_local_bwd", "float16")
    got = banded_flash_attention_local_bwd(*args)
    if native.launches("banded_flash_attention_local_bwd", "float16") != before + 1:
        raise AssertionError("banded_flash_attention_local_bwd fp16: the fp16 entry did not launch")
    want = banded_flash_attention_local_bwd_reference(*args)
    stats = {n: _agreement(a, r, f"banded_flash_attention_local_bwd fp16 {n}")
             for n, a, r in zip(("dq", "dk", "dv"), got, want)}
    deterministic = _determinism(banded_flash_attention_local_bwd, args, "banded_flash_attention_local_bwd fp16")
    # one rank: its dq is B5's video rows; its partials plus the global queries' B2 part are B5's dk, dv
    from s2v_torch.kernels.flash_attention_bwd import flash_attention_bwd

    b5 = banded_flash_attention_bwd(q, k, v, o, lse, do, *BAND)
    glob = flash_attention_bwd(q[:, :g_len], k, v, o[:, :g_len], lse[..., :g_len].contiguous(), do[:, :g_len])
    stitched = {"dq": _compact(_agreement(got[0], b5[0][:, g_len:], "fp16 B7 dq vs B5")),
                "dk": _compact(_agreement(got[1] + glob[1], b5[1], "fp16 B7 dk + B2 vs B5")),
                "dv": _compact(_agreement(got[2] + glob[2], b5[2], "fp16 B7 dv + B2 vs B5"))}
    del got, want, b5, glob
    banded_flash_attention_local_bwd(*args)  # warm-up
    ms = cuda_ms(lambda: banded_flash_attention_local_bwd(*args), 10)
    plain_ms = cuda_ms(lambda: banded_flash_attention_local_bwd_reference(*args), 2)
    library_ms, library_shape, library_failed = _masked_sdpa_ms(
        q[:, g_len:], k, v, torch.arange(g_len, s, device=dev), geo, grad=do[:, g_len:])
    flops = 10 * b * h * d * geo.shard_pairs()
    sq = s - g_len
    bound_ms, bound_by = _fp16_bound(flops, (3 * sq + 4 * s) * b * h * d * 2 + 2 * b * h * sq * 4)
    result = {"phase": "kernel_banded_local_bwd_fp16_main", "dtype": "float16", "shape": list(TRAIN_SHAPE_2B),
              "q_shape": [b, sq, h, d], "band": list(BAND), "grads": stats, "stitched_vs_b5": stitched,
              "deterministic": deterministic, "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
              "library_shape": library_shape, "library_not_run": library_failed, "bound_ms": bound_ms,
              "bound_by": bound_by, "tflops": flops / ms / 1e9,
              "small_worst_schedule_share": max(c["schedule_share"] for c in small)}
    emit(result)
    return result


def phase_kernel_int8_fp16(dev):
    """Kernel B3 in fp16 (the 2b family with ``--quantize_int8
    --attention_backend pallas_int8``) against its plain version and the
    emulation of its schedule (P rounded to fp16), its fp16 pre-pass
    kernels against ``int8_prepass`` bit for bit: small ragged shapes, then
    the 2b shape B=2, S=19,126, H=30, two launches bit for bit, timed beside
    its bound (tensor cores, the exponentials on the SFUs, bytes), the plain
    version and fp16 B1 online at the same shape (no PyTorch call computes
    int8-QK attention)."""
    import torch

    from s2v_torch.kernels import native
    from s2v_torch.kernels.flash_attention import flash_attention
    from s2v_torch.kernels.int8_attention import flash_attention_qk_int8, flash_attention_qk_int8_reference

    fp16 = torch.float16
    small = []
    for (b, sq, skv, h) in [(2, 90, 90, 2), (1, 200, 77, 3), (2, 77, 333, 2), (1, 310, 438, 2)]:
        q, k, v = _qkv(b, sq, skv, h, sq + skv + 81, dev, fp16)
        small.append({"q": [b, sq, h, 64], "skv": skv, **_compare_int8(q, k, v, schedule=True)})
    emit({"phase": "kernel_int8_fp16_small", "cases": small})

    b, s, h, d = MAIN_SHAPE_2B
    q, k, v = _ln_qkv(b, s, h, 83, dev, fp16)
    before = native.launches("flash_attention_qk_int8", "float16")
    stats = _compare_int8(q, k, v)
    if native.launches("flash_attention_qk_int8", "float16") != before + 1:
        raise AssertionError("flash_attention_qk_int8 fp16: the fp16 entry did not launch")
    if not torch.equal(flash_attention_qk_int8(q, k, v), flash_attention_qk_int8(q, k, v)):
        raise AssertionError("flash_attention_qk_int8 fp16: two launches on the same inputs differ")
    flash_attention_qk_int8(q, k, v)  # warm-up
    ms = cuda_ms(lambda: flash_attention_qk_int8(q, k, v), 10)
    plain_ms = cuda_ms(lambda: flash_attention_qk_int8_reference(q, k, v), 2)
    flash_attention(q, k, v, softmax_mode="online")  # warm-up
    b1_online_ms = cuda_ms(lambda: flash_attention(q, k, v, softmax_mode="online"), 10)
    products = 2 * b * h * s * s * d  # each of q·kᵀ (int8) and P·V (fp16)
    tensor_ms = (products / PEAK_INT8_OPS + products / PEAK_FP16_FLOPS) * 1e3
    exp_ms, sfu = _sfu_exp_ms(b * h * s * s)
    bytes_ms = 4 * b * s * h * d * 2 / PEAK_BYTES_PER_S * 1e3
    bound_ms, set_by = max((tensor_ms, "tensor cores"), (exp_ms, "exponentials (SFU)"), (bytes_ms, "bytes"))
    result = {"phase": "kernel_int8_fp16_main", "dtype": "float16", "shape": list(MAIN_SHAPE_2B), **stats,
              "deterministic": True, "ms": ms, "plain_ms": plain_ms, "library_ms": None,
              "b1_online_ms": b1_online_ms, "bound_ms": bound_ms,
              "bound_by": "bytes" if set_by == "bytes" else "operations", "bound_set_by": set_by,
              "bound_parts_ms": {"tensor_cores": tensor_ms, "exponentials": exp_ms, "bytes": bytes_ms, **sfu},
              "tops": 2 * products / ms / 1e9,
              "small_worst_schedule_share": max(c["schedule_max_abs_err"] / c["schedule_max_abs_tol"]
                                                for c in small)}
    emit(result)
    return result


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


def phase_kernel_qk_norm_rope(dev):
    """The q/k LayerNorms and RoPE kernel (``kernels/qk_norm_rope.py``)
    against the emulation of its arithmetic and the plain chain, within the
    bf16/fp16 limits: small shapes (heads below, at and past its 4-head
    items; bf16 and fp16; with tables and without; the norm params in the
    storage type, and in fp32, which the wrapper rounds to it as the plain
    chain does) on strided views of a fused qkv output, then
    the 5b shape (bf16 [2, 19126, 48, 64], the segmented tables of a
    49x480x720 clip) and the 2b shape (fp16 [2, 19126, 30, 64], no tables),
    each timed over 10 launches beside its bound (q and k read once and
    written once, and the tables, at 3.35 TB/s) and the plain chain over 2
    calls."""
    import torch

    from s2v_torch.config import TransformerConfig
    from s2v_torch.kernels import native
    from s2v_torch.kernels.qk_norm_rope import qk_norm_rope, qk_norm_rope_emulated, qk_norm_rope_reference
    from s2v_torch.ops.rope import build_segmented_rope, prepare_video_and_ref_rope

    eps = TransformerConfig().qk_norm_eps

    def tables(height, width, frames, text_len):
        vc, vs, rc, rs = prepare_video_and_ref_rope(height, width, frames, 64)
        return build_segmented_rope(text_len, rc, rs, vc, vs, device=dev)

    def inputs(b, s, h, dtype, seed, params_dtype=None):
        # q and k as the DiT has them: views of one fused qkv output, rows with a nonzero mean
        g = torch.Generator(device=dev).manual_seed(seed)
        qkv = torch.randn(b, s, 3 * h * 64, device=dev, generator=g) * 2 + torch.randn(b, s, 1, device=dev,
                                                                                       generator=g)
        q, k, _ = qkv.to(dtype).chunk(3, dim=-1)
        pd = params_dtype or dtype
        norms = tuple({"weight": (1 + 0.1 * torch.randn(64, device=dev, generator=g)).to(pd),
                       "bias": (0.02 * torch.randn(64, device=dev, generator=g)).to(pd)} for _ in range(2))
        return q.reshape(b, s, h, 64), k.reshape(b, s, h, 64), norms

    def compare(q, k, norms, rope, what):
        before = native.launches("qk_norm_rope")
        got = qk_norm_rope(q, k, *norms, eps, *rope)
        if native.launches("qk_norm_rope") != before + 1:
            raise AssertionError(f"{what}: the kernel did not launch")
        emulated = qk_norm_rope_emulated(q, k, *norms, eps, *rope)
        plain = qk_norm_rope_reference(q, k, *norms, eps, *rope)
        return {name: {"emulated": _compact(_agreement(g, e, f"{what} {name} against the emulation")),
                       "plain": _compact(_agreement(g, p, f"{what} {name} against the plain chain"))}
                for name, g, e, p in zip("qk", got, emulated, plain)}

    small = []
    for (b, h, geo) in [(1, 3, (32, 32, 3, 5)), (2, 13, (64, 96, 4, 17)), (1, 48, (48, 64, 2, 226))]:
        rope = tables(*geo)
        for dtype in (torch.bfloat16, torch.float16):
            for with_rope in (True, False):
                q, k, norms = inputs(b, rope[0].shape[0], h, dtype, b + h)
                what = f"qk_norm_rope {tuple(q.shape)} {dtype} rope={with_rope}"
                small.append({"shape": list(q.shape), "dtype": str(dtype).replace("torch.", ""), "rope": with_rope,
                              **compare(q, k, norms, rope if with_rope else (None, None), what)})
    q, k, norms = inputs(2, 137, 13, torch.bfloat16, 5, params_dtype=torch.float32)
    small.append({"shape": list(q.shape), "dtype": "bfloat16", "rope": True, "params": "float32",
                  **compare(q, k, norms, tables(64, 96, 4, 17), "qk_norm_rope fp32 params")})
    emit({"phase": "kernel_qk_norm_rope_small", "cases": small})

    main = {}
    for model, (b, s, h, d), dtype, rope in (("5b", MAIN_SHAPE, torch.bfloat16, tables(480, 720, 13, 226)),
                                             ("2b", SHAPES_2B["s2v"], torch.float16, (None, None))):
        q, k, norms = inputs(b, s, h, dtype, 7)
        stats = compare(q, k, norms, rope, f"qk_norm_rope {model}")
        ms = cuda_ms(lambda: qk_norm_rope(q, k, *norms, eps, *rope), 10)
        plain_ms = cuda_ms(lambda: qk_norm_rope_reference(q, k, *norms, eps, *rope), 2)
        # q and k read once and written once, the tables read once
        nbytes = 4 * q.numel() * q.element_size() + sum(t.numel() * 4 for t in rope if t is not None)
        bound_ms = nbytes / PEAK_BYTES_PER_S * 1e3
        main[model] = {"shape": [b, s, h, d], "dtype": str(dtype).replace("torch.", ""), "rope": rope[0] is not None,
                       **stats, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
                       "bytes": nbytes, "tb_per_s": nbytes / ms / 1e9, "bound_share": bound_ms / ms}
        del q, k
    counts = read_counts()
    result = {"phase": "kernel_qk_norm_rope", "main": main, "launches": counts["qk_norm_rope"],
              "launches_by_dtype": counts["qk_norm_rope_by_dtype"]}
    emit(result)
    return result


# the adaLN kernel's main shapes: (B, (text, ref, video) tokens, D, dtype)
ADALN_SHAPES = {"5b": (2, (226, 1350, 17550), 3072, "bfloat16"), "2b": (2, (226, 1350, 17550), 1920, "float16"),
                "1.5": (2, (226, 4080, 44880), 3072, "bfloat16")}


def phase_kernel_adaln(dev):
    """The adaLN-Zero LayerNorms, modulation and stream join kernel
    (``kernels/adaln.py``) against the emulation of its arithmetic and the
    plain chain (the three plain streams and a ``torch.cat``), within the
    bf16/fp16 limits: small ragged shapes (a zero-width ref, widths below,
    at and between its vector buckets, strided streams, one stream as the
    output norm calls it, fp32 norm params), then the 5b (bf16 [2, 19126,
    3072]), 2b (fp16, D = 1,920) and 1.5 (bf16 [2, 49186, 3072]) shapes,
    each timed over 10 launches queued behind a device sleep (the wrapper's
    host work is near the kernel's 0.1-0.2 ms) beside its bound (the
    streams read once and the joined rows written once at 3.35 TB/s), a
    contiguous copy of the same bytes (``Tensor.copy_``, for scale) and the
    plain chain over 2 calls."""
    import torch

    from s2v_torch.kernels import native
    from s2v_torch.kernels.adaln import (
        adaln_zero_join,
        adaln_zero_join_emulated,
        adaln_zero_join_reference,
        ulps_from_emulation,
    )

    eps = 1e-5

    def inputs(b, lens, d, dtype, seed, params_dtype=None):
        # rows with a nonzero mean each; (shift, scale) views of one [B, 6D] modulation, the ref's the video's
        g = torch.Generator(device=dev).manual_seed(seed)
        streams = [(torch.randn(b, n, d, device=dev, generator=g) * 2 + torch.randn(b, n, 1, device=dev, generator=g))
                   .to(dtype) for n in lens]
        c = (0.5 * torch.randn(b, 6 * d, device=dev, generator=g)).chunk(6, dim=-1)
        pd = params_dtype or dtype
        norm = {"weight": (1 + 0.1 * torch.randn(d, device=dev, generator=g)).to(pd),
                "bias": (0.05 * torch.randn(d, device=dev, generator=g)).to(pd)}
        return streams, [(c[3], c[4]), (c[0], c[1]), (c[0], c[1])][:len(lens)], norm

    def compare(streams, mods, norm, what):
        before = native.launches("adaln_zero_join")
        got = adaln_zero_join(streams, mods, norm, eps)
        if native.launches("adaln_zero_join") != before + 1:
            raise AssertionError(f"{what}: the kernel did not launch")
        emulated = adaln_zero_join_emulated(streams, mods, norm, eps)
        ulps = ulps_from_emulation(got, emulated)
        if ulps > 1:
            raise AssertionError(f"{what}: {ulps} ulps from the emulation")
        plain = adaln_zero_join_reference(streams, mods, norm, eps)
        return {"ulps_from_emulation": ulps, "plain": _compact(_agreement(got, plain, f"{what} against the plain chain"))}

    small = []
    for b, lens, d in [(1, (5, 7, 12), 64), (2, (9, 0, 21), 96), (2, (3, 17, 40), 1920), (1, (2, 3, 5), 3072),
                       (2, (4, 4, 33), 4096), (2, (37,), 256)]:
        for dtype in (torch.bfloat16, torch.float16):
            streams, mods, norm = inputs(b, lens, d, dtype, d + sum(lens))
            what = f"adaln {b}x{lens}x{d} {dtype}"
            small.append({"batch": b, "lens": list(lens), "dim": d, "dtype": str(dtype).replace("torch.", ""),
                          **compare(streams, mods, norm, what)})
    streams, mods, norm = inputs(2, (30, 30, 30), 512, torch.bfloat16, 5, params_dtype=torch.float32)
    strided = [streams[0][:, :6, :256], streams[1][:, 6:, 256:], streams[2][:, :, 128:384]]
    small.append({"batch": 2, "lens": [6, 24, 30], "dim": 256, "dtype": "bfloat16", "strided": True,
                  "params": "float32", **compare(strided, [(a[:, :256], c[:, :256]) for a, c in mods],
                                                 {k: v[:256] for k, v in norm.items()}, "adaln strided")})
    emit({"phase": "kernel_adaln_small", "cases": small})

    main = {}
    for model, (b, lens, d, dtype_name) in ADALN_SHAPES.items():
        dtype = getattr(torch, dtype_name)
        streams, mods, norm = inputs(b, lens, d, dtype, 7)
        stats = compare(streams, mods, norm, f"adaln {model}")
        ms = queued_ms(lambda: adaln_zero_join(streams, mods, norm, eps), 10)
        plain_ms = queued_ms(lambda: adaln_zero_join_reference(streams, mods, norm, eps), 2)
        src = torch.cat(streams, dim=1)
        dst = torch.empty_like(src)
        copy_ms = queued_ms(lambda: dst.copy_(src), 10)
        # the streams read once and the joined rows written once
        nbytes = 2 * src.numel() * src.element_size()
        bound_ms = nbytes / PEAK_BYTES_PER_S * 1e3
        main[model] = {"batch": b, "lens": list(lens), "dim": d, "dtype": dtype_name, **stats, "ms": ms,
                       "plain_ms": plain_ms, "copy_ms": copy_ms, "bound_ms": bound_ms, "bound_by": "bytes",
                       "bytes": nbytes, "tb_per_s": nbytes / ms / 1e9, "bound_share": bound_ms / ms}
        del streams, src, dst
        torch.cuda.empty_cache()
    counts = read_counts()
    result = {"phase": "kernel_adaln", "main": main, "launches": counts["adaln"],
              "launches_by_dtype": counts["adaln_by_dtype"]}
    emit(result)
    return result


def reset_counts():
    """Every count of the port's launch registry set to 0."""
    from s2v_torch.kernels import native

    native.reset_counts()


# the attention kernels whose counts check_counts reads: read_counts gives
# each of them, launched or not, and the sums below add them by name
ATTENTION_KERNELS = ("flash_attention", "flash_attention_bwd", "banded_flash_attention", "banded_flash_attention_bwd",
                     "flash_attention_qk_int8", "banded_flash_attention_local", "banded_flash_attention_local_bwd")


def read_counts() -> dict:
    """The launch registry's counts (``s2v_torch.kernels.native``): every
    counted kernel or event under its own name, with ``<name>_by_dtype``;
    and under the smoke's names, each of ``ATTENTION_KERNELS`` (0 when it
    did not launch), B1's by batch, its online re-runs and B3's pre-pass
    launches, and the q/k norm and adaLN kernels' launches and the calls
    that took their plain chains (no attention backend: each generate
    checks them on its own)."""
    from s2v_torch.kernels import native

    counts = native.counts()
    n = lambda kernel: counts.get(kernel, {}).get("launches", 0)  # noqa: E731
    by_dtype = lambda kernel: counts.get(kernel, {}).get("dtype", {})  # noqa: E731
    by_batch = counts.get("flash_attention", {}).get("batch", {})
    return {**{k: n(k) for k in counts}, **{f"{k}_by_dtype": by_dtype(k) for k in counts},
            **{name: n(name) for name in ATTENTION_KERNELS}, "reruns": n("flash_attention_rerun"),
            "qk_norm_rope": n("qk_norm_rope"), "qk_norm_rope_plain": n("qk_norm_rope_plain"),
            "qk_norm_rope_by_dtype": by_dtype("qk_norm_rope"),
            "adaln": n("adaln_zero_join"), "adaln_plain": n("adaln_zero_join_plain"),
            "adaln_by_dtype": by_dtype("adaln_zero_join"),
            "flash_attention_qk_int8_prepass": n("flash_attention_qk_int8_prepass"),
            "flash_attention_by_batch": {str(b): k for b, k in by_batch.items()},
            **{f"{name}_by_dtype": by_dtype(name) for name in ATTENTION_KERNELS}}


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

    t0 = time.perf_counter()
    tcfg, t5cfg, vcfg = TransformerConfig(), T5Config(), VAEConfig()
    pipe = S2VPipeline(
        transformer_params=init_transformer_params_random(tcfg, seed=0, device=dev), transformer_cfg=tcfg,
        vae_params=init_vae_params_random(vcfg, seed=2, device=dev), vae_cfg=vcfg,
        t5_params=init_t5_params_random(t5cfg, seed=1, device=dev), t5_cfg=t5cfg,
        tokenizer=smoke_tokenizer(), device=dev,
    )
    torch.cuda.synchronize()
    emit({"phase": "init", "init_s": time.perf_counter() - t0, "weights_gb": torch.cuda.memory_allocated() / 1e9})
    return pipe


def smoke_tokenizer():
    """A tokenizer over a tiny ``spiece.model`` written into ``build/``."""
    from s2v_torch.utils.sp_native import NativeSPTokenizer, write_spiece_model

    write_spiece_model(SMOKE_SPIECE, [
        ("<pad>", 0.0, 3), ("</s>", 0.0, 3), ("<unk>", 0.0, 2), ("▁", -4.0, 1), ("▁a", -2.0, 1),
        ("▁pig", -1.0, 1), ("▁walk", -1.5, 1), ("ing", -1.2, 1), ("▁in", -2.0, 1), ("▁the", -2.0, 1),
        ("▁park", -2.0, 1),
    ])
    return NativeSPTokenizer(SMOKE_SPIECE)


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
    if counts["qk_norm_rope"] != 2 * tcfg.num_layers or counts["qk_norm_rope_plain"]:
        raise AssertionError(f"{backend} generate: qk_norm_rope launches {counts['qk_norm_rope']} and plain calls "
                             f"{counts['qk_norm_rope_plain']}; expected {2 * tcfg.num_layers} and 0")
    if counts["adaln"] != 2 * (2 * tcfg.num_layers + 1) or counts["adaln_plain"]:
        raise AssertionError(f"{backend} generate: adaln launches {counts['adaln']} and plain calls "
                             f"{counts['adaln_plain']}; expected {2 * (2 * tcfg.num_layers + 1)} and 0")
    emit({"phase": name or ("e2e" if backend == "flash" else f"e2e_{backend}"), "backend": backend, **(extra or {}),
          "window": window if backend in ("windowed", "sp_windowed") else None, "num_frames": num_frames, "steps": 2,
          "output_shape": list(video.shape), "launches": counts,
          "encode_prompt_s": timings["encode_prompt_s"], "encode_ref_s": timings["encode_ref_s"],
          "denoise_step_s": timings["denoise_step_s"], "decode_s": timings["decode_s"], "wall_s": wall_s,
          "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
          "output_mean": float(video.mean()), "output_std": float(video.std()), "profiled_step": profiled})
    # the profiled 1-step generate's latents and the clip, for comparing backends on the same seed
    return {**counts, "latents": latents.float().cpu(), "video": video, "profiled_step": profiled}


_TRAIN_BATCHES = {}


def train_steps(pipe, dev, height, width, num_frames, steps, spec, optimizer_spec, backend, profile=True):
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
    # the same seeded clip, VAE and T5 give the same batch: encoded once per pipeline and geometry
    key = (id(pipe.vae_params), height, width, num_frames)
    if key not in _TRAIN_BATCHES:
        _TRAIN_BATCHES[key] = next(latent_batches([item], pipe, batch_size=1, seed=0))
    batch = dict(_TRAIN_BATCHES[key])
    f_lat = batch["video_latents"].shape[1]
    # the RoPE tables, as the JAX on-chip train probe adds them (the JAX
    # trainer CLI's batches carry none)
    batch["rope_cos"], batch["rope_sin"] = pipe.prepare_rope(height, width, f_lat)
    pos_embedding = pipe.prepare_pos_embedding(height, width, num_frames)
    if pos_embedding is not None:  # a sincos (2b) model: its table, which the JAX trainer never adds (C.19)
        batch["pos_embedding"] = pos_embedding
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
        b_zero_targets = sorted(name for name, ab in lora.items() if not bool(ab["b"].any()))
    profiled = None
    if dev.type == "cuda" and profile:
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
        "step_s": step_s, "launches": counts, "b_nonzero": b_nonzero, "b_zero_targets_last_step": b_zero_targets,
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
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
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
        if c["qk_norm_rope"]:  # q and k need gradients: the plain chain
            problems.append(f"step {i} launched qk_norm_rope {c['qk_norm_rope']} times")
        if c["adaln"]:  # the streams and the modulation need gradients: the plain chain
            problems.append(f"step {i} launched the adaln kernel {c['adaln']} times")
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
    if pipe.device.type == "cuda":
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


def phase_e2e_sp_allgather(dev, pipe, backend="sp_allgather"):
    """``e2e`` at full depth after ``set_mesh("sp1")`` (a one-rank ``seq``
    mesh over the NCCL group of ``sp_mesh``) with the explicit backend
    ``sp_allgather``: 84 B1 launches; its latents and clip are held
    against ``e2e``'s after the run (``sp_allgather_vs_e2e``)."""
    sp_mesh()
    pipe.set_mesh("sp1")
    try:
        r = phase_e2e(dev, pipe, backend, name="e2e_sp_allgather", extra={"seq_ring": pipe._seq_ring()})
    finally:
        pipe.set_mesh(None)
    return r


def sp_allgather_vs_e2e(sp, single) -> dict:
    """``e2e_sp_allgather``'s clip and 1-step latents against ``e2e``'s:
    bit for bit, or else within B1's limits, with the reason; raises
    otherwise.  Also the one-rank collectives' host and device time in its
    profiled step."""
    import torch

    line = {"phase": "sp_allgather_vs_e2e"}
    for key in ("video", "latents"):
        a, b = torch.as_tensor(np.asarray(sp[key])), torch.as_tensor(np.asarray(single[key]))
        same = bool(torch.equal(a, b))
        line[key] = {"bitwise_equal": same}
        if not same:
            line[key].update(_agreement(a, b, f"e2e_sp_allgather {key} against e2e's"),
                             why="the one-rank gather hands B1 the same values in another buffer")
    prof = sp["profiled_step"]
    line["collectives_in_profiled_step"] = {
        "device_ms": prof["device_ms_by_family"].get("collectives (NCCL)", 0.0), "host": prof["collectives_host"]}
    return line


def _sp_wrappers_vs_plain(dev, shape=MAIN_SHAPE, band=BAND):
    """The sequence-parallel wrappers on one rank at the main path's shape
    (B=2, S=19,126, H=48, q/k LayerNormed; the frame shard of 13 frames of
    1,350 tokens after 1,576 global rows), each held against its kernel's
    plain version on the same inputs: sp_allgather, sp_ulysses and ring (B1,
    ring with its lse) against ``flash_attention_reference``, sp_int8 (B3)
    against ``flash_attention_qk_int8_reference``."""
    from s2v_torch.kernels.flash_attention import flash_attention_reference
    from s2v_torch.kernels.int8_attention import flash_attention_qk_int8_reference
    from s2v_torch.parallel.context import FrameShard
    from s2v_torch.parallel.ring_attention import ring_attention
    from s2v_torch.parallel.sp_attention import allgather_kv_attention, ulysses_attention

    b, s, h, _ = shape
    g, tpf, _ = band
    group = sp_mesh().get_group("seq")
    shard = FrameShard((s - g) // tpf, tpf, 1, 0, group)
    q, k, v = _ln_qkv(b, s, h, 70, dev)
    o_ref, lse_ref = flash_attention_reference(q, k, v, return_lse=True, softmax_mode=MAIN_MODE)
    out = {"sp_allgather": _agreement(allgather_kv_attention(q, k, v, shard, g), o_ref, "sp_allgather"),
           "sp_ulysses": _agreement(ulysses_attention(q, k, v, shard, g), o_ref, "sp_ulysses")}
    o, lse = ring_attention(q, k, v, shard, g, return_lse=True)
    lse_err = (lse - lse_ref).abs().max().item()
    if not lse_err < LSE_TOL:
        raise AssertionError(f"ring: lse max_abs_err {lse_err} (tol {LSE_TOL})")
    out["ring"] = {**_agreement(o, o_ref, "ring"), "lse_err": lse_err, "lse_tol": LSE_TOL}
    out["sp_int8"] = _agreement(allgather_kv_attention(q, k, v, shard, g, int8=True),
                                flash_attention_qk_int8_reference(q, k, v), "sp_int8")
    return out


def phase_e2e_sp_backends(dev, pipe, backend="sp_ulysses", height=480, width=720, num_frames=49,
                          wrapper_shape=MAIN_SHAPE, wrapper_band=BAND):
    """At the cut depth on the one-rank mesh: first the wrappers against
    the plain versions (``_sp_wrappers_vs_plain``); then a 2-step generate
    to latents with ``flash``, ``sp_ulysses``, ``ring``, ``flash_int8``
    and ``sp_int8``, each counted: one B1 a block and step for ``sp_ulysses``
    and ``ring`` (one hop), one B3 and one pre-pass and no B1 for
    ``sp_int8``; each sequence-parallel backend's latents against its
    single-card one's (``flash``, ``flash_int8``), bit for bit or within
    B1's limits with the reason printed; then one profiled step of each
    sequence-parallel backend (device time by family, the collectives)."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    t_phase = time.perf_counter()
    wrappers = _sp_wrappers_vs_plain(dev, wrapper_shape, wrapper_band)
    L = pipe.transformer_cfg.num_layers
    image = np.clip(np.random.RandomState(42).randn(height, width, 3).astype(np.float32) * 0.5, -1, 1)
    kw = dict(prompt="a pig walking in the park", ref_image=image, height=height, width=width,
              num_frames=num_frames, guidance_scale=6.0, seed=42, output_type="latent")
    pairs = {"sp_ulysses": "flash", "ring": "flash", "sp_int8": "flash_int8"}
    saved = pipe.attention_backend
    pipe.set_mesh("sp1")
    runs, profiled = {}, {}
    try:
        for name in ("flash", "sp_ulysses", "ring", "flash_int8", "sp_int8"):
            pipe.set_attention(name)
            reset_counts()
            t0 = time.perf_counter()
            latents = pipe.generate(num_inference_steps=2, **kw).float().cpu()
            runs[name] = {"latents": latents, "counts": read_counts(), "wall_s": time.perf_counter() - t0,
                          "denoise_step_s": pipe.timings["denoise_step_s"]}
        for name in pairs:
            pipe.set_attention(name)
            with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                pipe.generate(num_inference_steps=1, **kw)
            profiled[name] = {"step_s": pipe.timings["denoise_step_s"][0], **device_breakdown(prof)}
    finally:
        pipe.set_mesh(None)
        pipe.set_attention(saved)
    line = {"phase": "e2e_sp_backends", "seq_ring": 1, "depth": L, "wrappers_vs_plain": wrappers, "backends": {}}
    for name, single in pairs.items():
        got, want = runs[name]["latents"], runs[single]["latents"]
        if not check_counts(runs[name]["counts"], "flash_int8" if name == "sp_int8" else "flash", 2 * L, 0):
            raise AssertionError(f"e2e_sp_backends: {name} launches {runs[name]['counts']}")
        same = bool(torch.equal(got, want))
        entry = {"vs": single, "bitwise_equal": same, "launches": runs[name]["counts"],
                 "wall_s": runs[name]["wall_s"], "denoise_step_s": runs[name]["denoise_step_s"],
                 "vs_denoise_step_s": runs[single]["denoise_step_s"], "profiled_step": profiled.get(name)}
        if not same:
            entry["agreement"] = _agreement(got, want, f"{name} latents against {single}'s")
            entry["why"] = ("the one-rank path hands the kernel the same values in other buffers (gathered K/V, "
                            "a merged hop in fp32); held to B1's limits")
        line["backends"][name] = entry
    line["seconds"] = time.perf_counter() - t_phase
    emit(line)
    # the kernels line reads this phase's launches: the sequence-parallel runs'
    return {k: sum(runs[n]["counts"][k] for n in pairs)
            for k in ATTENTION_KERNELS + ("reruns", "flash_attention_qk_int8_prepass")}


def phase_train_sp_backends(dev, pipe, backend="sp_allgather", height=480, width=720, num_frames=49):
    """At the cut depth: a LoRA step's loss and gradients (rank 128, the
    seven target families, remat, b seeded nonzero) on the ``train`` phase's
    clip with seeded draws, with ``flash`` and then, in the one-rank mesh's
    context, ``sp_allgather`` and ``ring``, each counted (B1 twice and B2
    once a block for flash and sp_allgather; ring's backward is fp32
    PyTorch math, no B2) and timed.  Each loss must equal the exact step's,
    and its gradients must lie within the kernels' limits of the exact
    step's."""
    import torch

    from s2v_torch.parallel import default_logical_map, mesh_context
    from s2v_torch.training.data import latent_batches
    from s2v_torch.training.lora import LoRASpec, init_lora_params, lora_leaves, lora_loss_fn
    from s2v_torch.schedulers.ddim import compute_alphas_cumprod
    from s2v_torch.config import SchedulerConfig

    t_phase = time.perf_counter()
    L = pipe.transformer_cfg.num_layers
    rng = np.random.RandomState(7)
    item = {"video": np.clip(rng.randn(num_frames, height, width, 3) * 0.5, -1, 1).astype(np.float32),
            "ref_image": np.clip(rng.randn(height, width, 3) * 0.5, -1, 1).astype(np.float32),
            "prompt": "a pig walking in the park"}
    key = (id(pipe.vae_params), height, width, num_frames)
    if key not in _TRAIN_BATCHES:
        _TRAIN_BATCHES[key] = next(latent_batches([item], pipe, batch_size=1, seed=0))
    batch = dict(_TRAIN_BATCHES[key])
    batch["rope_cos"], batch["rope_sin"] = pipe.prepare_rope(height, width, batch["video_latents"].shape[1])
    spec = LoRASpec(rank=128, alpha=64.0)
    params, cfg = pipe.transformer_params, pipe.transformer_cfg
    lora = init_lora_params(torch.Generator(device=dev).manual_seed(1), params, spec)
    for ab in lora.values():  # nonzero b, so that every a gets a gradient
        ab["b"].normal_(0.0, 1e-3, generator=torch.Generator(device=dev).manual_seed(2))
    alphas = torch.as_tensor(compute_alphas_cumprod(SchedulerConfig()), device=dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    timesteps = torch.randint(0, alphas.shape[0], (1,), generator=gen, device=dev)
    noise = torch.randn(batch["video_latents"].shape, generator=gen, device=dev)
    mesh = sp_mesh()
    runs = {}
    for name in ("flash", "sp_allgather", "ring"):
        leaves = lora_leaves(lora)
        for t in leaves:
            t.requires_grad_(True)
        ctx = mesh_context(mesh, default_logical_map(mesh)) if name != "flash" else nullcontext()
        reset_counts()
        t0 = time.perf_counter()
        with ctx:
            loss = lora_loss_fn(lora, params, cfg, spec, batch, alphas, None, name, True, timesteps=timesteps,
                                noise=noise)
            grads = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        runs[name] = {"loss": loss.item(), "grads": [g.float() for g in grads], "counts": read_counts(),
                      "seconds": time.perf_counter() - t0}
        for t in leaves:
            t.requires_grad_(False)
    line = {"phase": "train_sp_backends", "seq_ring": 1, "depth": L, "loss_flash": runs["flash"]["loss"],
            "loss_and_grad_s_flash": runs["flash"]["seconds"], "backends": {}}
    if not check_counts(runs["flash"]["counts"], "flash", 2 * L, L):
        raise AssertionError(f"train_sp_backends: flash launches {runs['flash']['counts']}")
    names = [f"{n}.{k}" for n in sorted(lora) for k in ("a", "b")]
    for name in ("sp_allgather", "ring"):
        r = runs[name]
        if not check_counts(r["counts"], "flash", 2 * L, L if name == "sp_allgather" else 0):
            raise AssertionError(f"train_sp_backends: {name} launches {r['counts']}")
        if r["loss"] != runs["flash"]["loss"]:
            raise AssertionError(f"train_sp_backends: {name} loss {r['loss']} against flash {runs['flash']['loss']}")
        grads = {n: _agreement(g, w, f"{name} grad {n}")
                 for n, g, w in zip(names, r["grads"], runs["flash"]["grads"])}
        worst = max(grads.values(), key=lambda s: s["rel_l2"])
        line["backends"][name] = {"loss": r["loss"], "loss_equal": True, "launches": r["counts"],
                                  "loss_and_grad_s": r["seconds"], "worst_grad": worst,
                                  "grads_rel_l2": {n: s["rel_l2"] for n, s in grads.items()}}
    line["seconds"] = time.perf_counter() - t_phase
    emit(line)
    return {"launches": [runs["sp_allgather"]["counts"], runs["ring"]["counts"]]}


def _torchrun(args, log):
    """``python3 -m torch.distributed.run --standalone --nproc_per_node 1``
    on ``args``, its output in ``log``."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "1", *args]
    logf = open(log, "w")
    proc = subprocess.Popen(cmd, cwd=str(REPO), env=dict(os.environ, PYTHONPATH=str(REPO)), stdout=logf,
                            stderr=subprocess.STDOUT)
    logf.close()
    return proc


# ``-m s2v_torch.cli`` under torchrun, which then prints its net B1 launches
_CLI_MESH_WRAPPER = """
import json, runpy, sys
sys.argv = ["s2v_torch.cli"] + sys.argv[1:]
runpy.run_module("s2v_torch.cli", run_name="__main__")
from s2v_torch.kernels import native
print(json.dumps({"cli_flash_attention_launches": native.launches("flash_attention")
                  - native.launches("flash_attention_rerun")}), flush=True)
"""


def phase_cli_mesh(dev, pipe, backend="flash", height=480, width=720, num_frames=49):
    """``python3 -m torch.distributed.run --standalone --nproc_per_node 1 -m
    s2v_torch.cli --mesh dp1,sp1,tp1 --text_encoder_device mesh`` (through a
    wrapper that prints the B1 launches, as ``pretrained`` runs the CLI) on
    the snapshot that ``pretrained`` wrote (no LoRA: its merge is
    ``pretrained``'s to time), 49x480x720, 2 steps: the DiT and T5 sliced
    over the one-rank model dim, the CFG rows over the data dim, the frames
    over the seq dim; exit 0, one clip, and the B1 launches of the plain CLI
    run (84)."""
    build = REPO / "build"
    snap, out_dir = build / "smoke_snapshot", build / "smoke_cli_mesh"
    if not snap.is_dir():
        raise AssertionError("cli_mesh runs on the snapshot of the pretrained phase")
    release_pipe(pipe, dev)
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    wrapper, png, log = out_dir / "cli_wrapper.py", out_dir / "ref.png", out_dir / "cli.log"
    wrapper.write_text(_CLI_MESH_WRAPPER)
    write_png(png, (np.random.RandomState(3).rand(height, width, 3) * 255).astype(np.uint8))
    t0 = time.perf_counter()
    proc = _torchrun([str(wrapper), "--pretrained_model_name_or_path", str(snap), "--ref_img_path", str(png), "--prompt", "<cls> a pig walking in the park",
                      "--height", str(height), "--width", str(width), "--max_num_frames", str(num_frames),
                      "--num_inference_steps", "2",
                      "--output_dir", str(out_dir / "out"), "--device", dev.type, "--mesh", MESH_SPEC,
                      "--text_encoder_device", "mesh"], log)
    rc = proc.wait(timeout=600)
    seconds = time.perf_counter() - t0
    lines = log.read_text().splitlines()
    if rc != 0:
        raise AssertionError(f"cli_mesh: exited {rc}:\n{_tail(log)}")
    counted = [json.loads(ln) for ln in lines if ln.startswith('{"cli_flash_attention_launches"')]
    wrote = [ln.split("[s2v_torch] wrote ", 1)[1] for ln in lines if "[s2v_torch] wrote " in ln]
    if len(wrote) != 1 or not Path(wrote[-1].strip()).is_file():
        raise AssertionError(f"cli_mesh: the clip is missing: {wrote}\n{_tail(log)}")
    launches = counted[-1]["cli_flash_attention_launches"] if counted else None
    if launches != 2 * pipe.transformer_cfg.num_layers:
        raise AssertionError(f"cli_mesh: B1 launches {launches}, the plain CLI's {2 * pipe.transformer_cfg.num_layers}")
    clip = Path(wrote[-1].strip())
    line = {"phase": "cli_mesh", "mesh": MESH_SPEC, "text_encoder_device": "mesh", "rc": rc, "seconds": seconds,
            "flash_attention_launches": launches,
            "clip": str(clip.relative_to(REPO)), "clip_bytes": clip.stat().st_size,
            "lines": [ln for ln in lines if "[s2v_torch]" in ln][-6:]}
    emit(line)
    return {"cli_flash_attention": launches}


def phase_serve_mesh(dev, pipe, backend="flash", height=480, width=720, num_frames=49):
    """The daemon under ``python3 -m torch.distributed.run --standalone
    --nproc_per_node 1 -m s2v_torch.serve --mesh sp1`` on the ``pretrained``
    snapshot (no LoRA): two 2-step generates at 49x480x720 answered
    ``"status": "ok"`` with their clips, then a shutdown, and the launcher
    exits 0."""
    from s2v_torch.serving.client import request

    build = REPO / "build"
    snap, out_dir = build / "smoke_snapshot", build / "smoke_serve_mesh"
    if not snap.is_dir():
        raise AssertionError("serve_mesh runs on the snapshot of the pretrained phase")
    release_pipe(pipe, dev)
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    sock, ready, log, png = out_dir / "s.sock", out_dir / "ready", out_dir / "serve.log", out_dir / "ref.png"
    write_png(png, (np.random.RandomState(5).rand(height, width, 3) * 255).astype(np.uint8))
    t_phase = time.perf_counter()
    proc = _torchrun(["-m", "s2v_torch.serve", "--pretrained_model_name_or_path", str(snap), "--socket", str(sock), "--ready_file", str(ready), "--device", dev.type,
                      "--mesh", "sp1"], log)
    gen = {"op": "generate", "prompt": "<cls> a pig walking in the park", "ref_img_path": str(png), "height": height,
           "width": width, "num_frames": num_frames, "num_inference_steps": 2}
    answers = {}
    try:
        while not ready.exists():
            if proc.poll() is not None or time.perf_counter() - t_phase > 600:
                raise AssertionError(f"serve_mesh: the daemon did not start (exit {proc.poll()}):\n{_tail(log)}")
            time.sleep(0.2)
        start_s = time.perf_counter() - t_phase
        for i in range(2):
            t0 = time.perf_counter()
            resp = request(str(sock), {**gen, "seed": 7 + i, "output_path": str(out_dir / f"clip{i}.mp4")},
                           timeout=900)
            clip = Path(resp.get("outputs", [""])[0])
            if resp.get("status") != "ok" or not clip.is_file() or not clip.stat().st_size:
                raise AssertionError(f"serve_mesh: request {i} answered {resp}\n{_tail(log)}")
            resp.pop("traceback", None)
            answers[f"generate_{i}"] = {"client_s": time.perf_counter() - t0, **resp, "clip_bytes": clip.stat().st_size}
        answers["shutdown"] = request(str(sock), {"op": "shutdown"})
        rc = proc.wait(timeout=120)
        if rc != 0:
            raise AssertionError(f"serve_mesh: exited {rc}:\n{_tail(log)}")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    line = {"phase": "serve_mesh", "start_s": start_s, "requests": answers, "seconds": time.perf_counter() - t_phase,
            "log_tail": _tail(log, 6).splitlines()}
    emit(line)
    return line


def phase_train_qlora(dev, pipe, backend="flash"):
    """QLoRA: the ``train`` phase's steps over the int8 base, flash both
    ways (B3 has no backward).  The int8 q and scale must not change.  The
    bf16 tree is restored after.  First one exact step on the same tree,
    batch and draws, whose loss the QLoRA loss is compared with (at a cut
    depth the ``train`` phase's is another model's)."""
    import torch

    from s2v_torch.ops.quant import QUANTIZED_LEAVES
    from s2v_torch.training.lora import LoRASpec
    from s2v_torch.training.optim import OptimizerSpec

    opt = OptimizerSpec(optimizer="adamw", learning_rate=1e-4, beta1=0.9, beta2=0.95, weight_decay=1e-4,
                        epsilon=1e-8, max_grad_norm=1.0, moment_dtype="bfloat16")
    exact = train_steps(pipe, dev, 480, 720, 49, 1, LoRASpec(rank=128, alpha=64.0), opt, backend, profile=False)
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
    return {**r, "first_loss_exact": exact["losses"][0]}


def write_png(path: Path, rgb: np.ndarray) -> None:
    """An 8-bit RGB PNG (no filtering) with the standard library only."""
    h, w, _ = rgb.shape

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF)

    raw = b"".join(b"\x00" + np.ascontiguousarray(rgb[y], np.uint8).tobytes() for y in range(h))
    path.write_bytes(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                     + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def smoke_lora_checkpoint(tcfg, rank=LORA_RANK, seed=7, std=LORA_STD) -> dict:
    """A seeded LoRA state dict with the diffusers keys over the reference's
    9 target families at the config's width, the k=2 conv patch embed
    included (the layout of ``tools/make_tiny_snapshot.py::lora_checkpoint``),
    fp32 CPU tensors."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    d, p = tcfg.inner_dim, tcfg.patch_size

    def normal(*shape):
        return torch.randn(shape, generator=gen) * std

    sd = {"transformer.patch_embed.proj.lora.down.weight": normal(rank, tcfg.in_channels, p, p),
          "transformer.patch_embed.proj.lora.up.weight": normal(d, rank, 1, 1)}

    def pair(module, in_dim, out_dim):
        sd[f"transformer.{module}.lora.down.weight"] = normal(rank, in_dim)
        sd[f"transformer.{module}.lora.up.weight"] = normal(out_dim, rank)

    pair("patch_embed.text_proj", tcfg.text_embed_dim, d)
    for i in range(tcfg.num_layers):
        pre = f"transformer_blocks.{i}"
        for n in ("to_q", "to_k", "to_v", "to_out.0"):
            pair(f"{pre}.attn1.{n}", d, d)
        pair(f"{pre}.norm1.linear", tcfg.time_embed_dim, 6 * d)
        pair(f"{pre}.norm2.linear", tcfg.time_embed_dim, 6 * d)
        pair(f"{pre}.ff.net.2", tcfg.ff_inner_dim, d)
    return sd


def _dir_bytes(path: Path) -> int:
    return sum(f.stat().st_size for f in path.rglob("*") if f.is_file())


def _trees_equal(a, b) -> bool:
    import torch

    if isinstance(a, dict):
        return isinstance(b, dict) and sorted(a) == sorted(b) and all(_trees_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_trees_equal(x, y) for x, y in zip(a, b))
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


def _run_cli(args, env) -> dict:
    """``python3 -m s2v_torch.cli`` in a subprocess (run as ``-m`` runs it),
    which then prints its net B1 launches on one JSON line."""
    code = ("import json, runpy, sys; sys.argv = ['s2v_torch.cli'] + sys.argv[1:]; "
            "runpy.run_module('s2v_torch.cli', run_name='__main__'); "
            "from s2v_torch.kernels import native; "
            "print(json.dumps({'cli_flash_attention_launches': native.launches('flash_attention') "
            "- native.launches('flash_attention_rerun')}))")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", code, *args], cwd=str(REPO), env=env, capture_output=True,
                          text=True, timeout=900)
    return {"rc": proc.returncode, "seconds": time.perf_counter() - t0, "stdout": proc.stdout, "stderr": proc.stderr}


def write_smoke_snapshot(pipe) -> dict:
    """The full-width pipeline as a bf16 diffusers snapshot in
    ``build/smoke_snapshot`` (``save_pretrained``, its tokenizer the smoke's
    ``spiece.model``) and a seeded rank-128 LoRA checkpoint in
    ``build/smoke_lora``, after a check of the free disk; returns their
    sizes and write seconds."""
    from s2v_torch.loaders.safetensors_io import save_safetensors

    build = REPO / "build"
    snap, lora_dir = build / "smoke_snapshot", build / "smoke_lora"
    remove_smoke_files()
    trees = (pipe.transformer_params, pipe.vae_params, pipe.t5_params)
    snapshot_bytes = sum(t.numel() * 2 for tree in trees for t in _tensors(tree))  # bf16 on disk
    lora_sd = smoke_lora_checkpoint(pipe.transformer_cfg)
    lora_params = sum(t.numel() for t in lora_sd.values())
    need, free = snapshot_bytes + 4 * lora_params + 2**30, shutil.disk_usage(build).free
    if free < need:
        raise RuntimeError(f"{need} bytes needed under {build} for the snapshot and the LoRA, {free} free")
    t0 = time.perf_counter()
    pipe.save_pretrained(str(snap), dtype="bfloat16")
    write_s = time.perf_counter() - t0
    # save_pretrained copies tokenizer files only from a snapshot the
    # pipeline was loaded from; this one's tokenizer is its spiece.model
    (snap / "tokenizer").mkdir()
    shutil.copy(SMOKE_SPIECE, snap / "tokenizer" / "spiece.model")
    written = _dir_bytes(snap)
    lora_dir.mkdir(parents=True)
    t0 = time.perf_counter()
    save_safetensors(lora_sd, str(lora_dir / "pytorch_lora_weights.safetensors"))
    return {"gb": written / 1e9, "write_s": write_s, "write_gb_per_s": written / 1e9 / write_s,
            "lora_gb": _dir_bytes(lora_dir) / 1e9, "lora_write_s": time.perf_counter() - t0,
            "disk_free_gb": free / 1e9, "lora_params": lora_params}


class cut_depth:
    """The pipeline's DiT cut to its first ``depth`` blocks for the block:
    the blocks' list sliced (no copy) and the config's ``num_layers`` set,
    both restored after."""

    def __init__(self, pipe, depth):
        self.pipe, self.depth = pipe, depth

    def __enter__(self):
        import dataclasses

        pipe = self.pipe
        self.saved = (pipe.transformer_params, pipe.transformer_cfg)
        if self.depth is not None:
            blocks = pipe.transformer_params["blocks"][:self.depth]
            pipe.transformer_params = {**pipe.transformer_params, "blocks": blocks}
            pipe.transformer_cfg = dataclasses.replace(pipe.transformer_cfg, num_layers=len(blocks))
            emit({"phase": "depth_cut", "blocks": len(blocks), "of": len(self.saved[0]["blocks"])})
        return pipe

    def __exit__(self, *exc):
        self.pipe.transformer_params, self.pipe.transformer_cfg = self.saved


def release_pipe(pipe, dev, keep_batches=False) -> None:
    """Drop the in-memory pipeline's weights (another process or pipeline
    needs the card).  ``keep_batches``: a pipeline none of whose encoded
    train batches were kept (the fp32 cast's) leaves the others' cache."""
    import gc

    import torch

    pipe.transformer_params = pipe.vae_params = pipe.t5_params = None
    pipe._prompt_embed_cache.clear()
    if not keep_batches:
        _TRAIN_BATCHES.clear()  # keyed on the VAE's identity, which a new pipeline may reuse
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def phase_pretrained(dev, pipe, backend="flash", height=480, width=720, num_frames=49):
    """The ``pretrained`` phase (see the module doc): snapshot and LoRA
    written, loaded back and checked, then the CLI on them.  It leaves
    ``pipe`` without weights, so it runs after every other pipeline phase.
    On the CPU (a rehearsal at a tiny size) it skips the memory figures, and
    the launch counts stay 0."""
    import gc

    import torch

    from s2v_torch import S2VPipeline

    t_phase = time.perf_counter()
    build = REPO / "build"
    snap, lora_dir, cli_out = build / "smoke_snapshot", build / "smoke_lora", build / "smoke_cli"
    shutil.rmtree(cli_out, ignore_errors=True)
    out = {"phase": "pretrained", "lora_rank": LORA_RANK}
    image = np.clip(np.random.RandomState(42).randn(480, 720, 3).astype(np.float32) * 0.5, -1, 1)
    kw = dict(prompt="a pig walking in the park", ref_image=image[:height, :width], height=height, width=width,
              num_frames=num_frames, guidance_scale=6.0, seed=42, num_inference_steps=1, output_type="latent")
    cuda = dev.type == "cuda"

    def memory_gb(fn):
        return fn() / 1e9 if cuda else None

    out["snapshot"] = write_smoke_snapshot(pipe)
    out["lora_params"] = out["snapshot"].pop("lora_params")

    base = pipe.generate(**kw).float()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    before = memory_gb(torch.cuda.memory_allocated)
    t0 = time.perf_counter()
    loaded = S2VPipeline.from_pretrained(str(snap), device=dev)
    if cuda:
        torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    weights = sum(_dir_bytes(snap / s) for s in ("transformer", "vae", "text_encoder"))
    out["load"] = {"load_s": load_s, "gb_read": weights / 1e9, "gb_per_s": weights / 1e9 / load_s,
                   "weights_gb": memory_gb(torch.cuda.memory_allocated) - before if cuda else None,
                   "max_memory_allocated_gb": memory_gb(torch.cuda.max_memory_allocated),
                   "tokenizer": type(loaded.tokenizer).__name__}
    for name in ("transformer_params", "vae_params", "t5_params"):
        if not _trees_equal(getattr(loaded, name), getattr(pipe, name)):
            raise AssertionError(f"pretrained: the loaded {name} differ from the in-memory pipeline's")
    out["load"]["tensors_bitwise_equal"] = True

    reset_counts()
    got = loaded.generate(**kw).float()
    counts = read_counts()
    if not torch.equal(got, base):
        raise AssertionError(f"pretrained: 1-step latents differ from the in-memory pipeline's: "
                             f"{_agreement(got, base, 'loaded against in-memory')}")
    if cuda and not check_counts(counts, backend, pipe.transformer_cfg.num_layers, 0):
        raise AssertionError(f"pretrained: 1-step generate launches {counts}; expected "
                             f"{pipe.transformer_cfg.num_layers} B1 and nothing else")
    out.update(latents_bitwise_equal=True, launches=counts)

    # the in-memory pipeline is done with: its weights go (the CLI needs the card)
    release_pipe(pipe, dev)

    def rel_l2(a, b):
        return ((a - b).square().sum() / b.square().sum()).sqrt().item()

    lora = {}
    for mode in ("merge", "runtime"):
        t0 = time.perf_counter()
        loaded.load_lora(str(lora_dir), mode=mode)
        if cuda:
            torch.cuda.synchronize()
        lora[f"{mode}_s"] = time.perf_counter() - t0
        lora[mode] = loaded.generate(**kw).float()
        if mode == "merge":  # the noise floor: the same merged weights under the plain attention
            loaded.set_attention("plain")
            lora["merge_plain"] = loaded.generate(**kw).float()
            loaded.set_attention("auto")
    merged, runtime, merged_plain = lora.pop("merge"), lora.pop("runtime"), lora.pop("merge_plain")
    diff = (merged - runtime).abs()
    noise, effect, rel = rel_l2(merged_plain, merged), rel_l2(got, merged), rel_l2(runtime, merged)
    within_tol = bool((diff <= LORA_MERGE_RUNTIME_TOL * (1 + runtime.abs())).all())
    ok = within_tol and rel <= LORA_NOISE_MULT * noise < effect
    out["lora"] = {**lora, "max_abs_diff": diff.max().item(), "tol_atol_rtol": LORA_MERGE_RUNTIME_TOL,
                   "within_tol": within_tol, "rel_l2": rel, "noise_rel_l2_plain_vs_b1": noise,
                   "noise_mult": LORA_NOISE_MULT, "adapter_effect_rel_l2": effect, "agree": ok}
    if not ok:
        raise AssertionError(f"pretrained: merge and runtime LoRA latents disagree: {out['lora']}")
    del loaded, got, base, merged, runtime, merged_plain, diff
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    out["card_free_gb_for_cli"] = memory_gb(lambda: torch.cuda.mem_get_info(dev)[0])

    png = build / "smoke_ref.png"
    write_png(png, (np.random.RandomState(3).rand(height, width, 3) * 255).astype(np.uint8))
    env = dict(os.environ, PYTHONPATH=str(REPO))
    cli = _run_cli(["--pretrained_model_name_or_path", str(snap), "--checkpoint_path", str(lora_dir),
                    "--ref_img_path", str(png), "--prompt", "<cls> a pig walking in the park",
                    "--height", str(height), "--width", str(width), "--max_num_frames", str(num_frames),
                    "--num_inference_steps", "2", "--output_dir", str(cli_out), "--device", dev.type], env)
    lines = cli["stdout"].splitlines()
    if cli["rc"] != 0:
        raise AssertionError(f"pretrained: the CLI exited {cli['rc']}:\n{cli['stdout'][-3000:]}\n"
                             f"{cli['stderr'][-3000:]}")
    wrote = [ln.split("[s2v_torch] wrote ", 1)[1] for ln in lines if ln.startswith("[s2v_torch] wrote ")]
    if len(wrote) != 1 or not Path(wrote[0]).is_file() or Path(wrote[0]).stat().st_size == 0:
        raise AssertionError(f"pretrained: the CLI's clip is missing or empty: {wrote}")
    clip = Path(wrote[0])
    writer = ("npy" if clip.suffix == ".npy" else "cv2" if "with OpenCV" in cli["stderr"] else "mp4_native")
    launches = json.loads(lines[-1])["cli_flash_attention_launches"]
    out["cli"] = {"rc": cli["rc"], "seconds": cli["seconds"], "clip": str(clip.relative_to(REPO)),
                  "clip_bytes": clip.stat().st_size, "writer": writer, "flash_attention_launches": launches,
                  "lines": [ln for ln in lines[:-1] if ln.startswith("[s2v_torch]")],
                  "stderr_tail": cli["stderr"].splitlines()[-5:]}
    if cuda and launches != 2 * pipe.transformer_cfg.num_layers:
        raise AssertionError(f"pretrained: the CLI's 2 steps launched B1 {launches} times")
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    return {**counts, "cli_flash_attention": launches}


def remove_smoke_files() -> None:
    """The snapshot and the LoRA that ``pretrained`` (or ``serve``) writes
    and ``serve`` reads; deleted when the script ends, whatever failed."""
    for name in ("smoke_snapshot", "smoke_lora"):
        shutil.rmtree(REPO / "build" / name, ignore_errors=True)


def phase_chunked(dev):
    """The ``chunked`` backend (PyTorch ops, no kernel) at the training
    shape (B=1, S=19,126, H=48, d=64, bf16, q/k LayerNormed): its forward and
    autograd backward against B1 and B2 (``flash_attention_trainable``) on
    the same inputs and dO, within the kernels' limits; its seconds, and its
    peak memory beside one query block's fp32 probabilities and the whole S²."""
    import torch

    from s2v_torch.ops.attention import chunked_attention, flash_attention_trainable

    b, s, h, _ = TRAIN_SHAPE
    q, k, v = (x.requires_grad_() for x in _ln_qkv(b, s, h, 60, dev))
    do = torch.randn(q.shape, device=dev, generator=torch.Generator(device=dev).manual_seed(61)).to(torch.bfloat16)
    o_ref = flash_attention_trainable(q, k, v)
    grads_ref = torch.autograd.grad(o_ref, (q, k, v), do)
    o_ref = o_ref.detach()
    seconds = []
    for _ in range(2):  # the first pass also pays cuBLAS's and autograd's first-call costs
        o = grads = None
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        o = chunked_attention(q, k, v, block_q=CHUNKED_BLOCK_Q)
        torch.cuda.synchronize()
        forward_s = time.perf_counter() - t0
        grads = torch.autograd.grad(o, (q, k, v), do)
        torch.cuda.synchronize()
        seconds.append({"forward_s": forward_s, "forward_backward_s": time.perf_counter() - t0})
        peak_gb = (torch.cuda.max_memory_allocated() - before) / 1e9
    block_gb, s2_gb = b * h * CHUNKED_BLOCK_Q * s * 4 / 1e9, b * h * s * s * 4 / 1e9
    agreement = {"o_vs_b1": _agreement(o, o_ref, "chunked forward against B1")}
    for name, a, r in zip(("dq", "dk", "dv"), grads, grads_ref):
        agreement[f"{name}_vs_b2"] = _agreement(a, r, f"chunked {name} against B2")
    line = {"phase": "chunked", "shape": list(TRAIN_SHAPE), "block_q": CHUNKED_BLOCK_Q, **seconds[1],
            "first_pass": seconds[0], "peak_gb_above_inputs": peak_gb, "one_block_fp32_probs_gb": block_gb,
            "whole_s2_fp32_probs_gb": s2_gb, "peak_in_blocks": peak_gb / block_gb,
            "peak_limit_blocks": CHUNKED_PEAK_BLOCKS, **agreement}
    if not peak_gb <= CHUNKED_PEAK_BLOCKS * block_gb:
        raise AssertionError(f"chunked: the backward's peak is not bounded by its query block: {line}")
    emit(line)
    return line


def _clip_checks(video, shape, what):
    if list(video.shape) != list(shape) or not np.isfinite(video).all() or video.min() < 0 or video.max() > 1:
        raise AssertionError(f"{what}: output {video.shape}, finite {np.isfinite(video).all()}, "
                             f"range [{video.min()}, {video.max()}]")


def phase_e2e_options(dev, pipe, backend="flash", height=480, width=720, num_frames=49):
    """The rest of ``generate`` at 49x480x720 on the full-width pipeline with
    ``backend``, 2 steps each: a DPM clip (B1 twice per block forward); the
    whole loop's latents against ``segment_steps=1``'s, bit for bit; a
    callback that stops after the first segment (one step run); a cfg-skip
    run (dynamic guidance, threshold 0.02: step 1 is cfg-skipped, so half of
    its B1 launches run at B=1); then the whole loop's latents decoded
    untiled and in quarter-size tiles (``_decode_lean_tiles``): seconds,
    peak memory, and the frame PSNR of lean against untiled (a finding).
    Runs on the CPU at a tiny size too (no launches, no memory figures)."""
    import torch

    from s2v_torch.pipelines.denoise import guidance_schedule
    from s2v_torch.utils.video import denormalize_video, psnr

    cuda, layers = dev.type == "cuda", pipe.transformer_cfg.num_layers

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def peak_gb():
        return torch.cuda.max_memory_allocated() / 1e9 if cuda else None

    def reset_peak():
        if cuda:
            torch.cuda.reset_peak_memory_stats()

    image = np.clip(np.random.RandomState(42).randn(height, width, 3).astype(np.float32) * 0.5, -1, 1)
    kw = dict(prompt="a pig walking in the park", ref_image=image, height=height, width=width,
              num_frames=num_frames, guidance_scale=6.0, seed=42, num_inference_steps=2)
    saved = (pipe.attention_backend, pipe.transformer_cfg)
    pipe.set_attention(backend)
    out = {"phase": "e2e_options", "backend": backend, "num_frames": num_frames, "steps": 2}
    try:
        reset_counts()
        t0 = time.perf_counter()
        video = pipe.generate(use_dpm=True, **kw)
        wall_s = time.perf_counter() - t0
        dpm_counts = read_counts()
        _clip_checks(video, (1, num_frames, height, width, 3), "e2e_options dpm")
        if cuda and not check_counts(dpm_counts, backend, 2 * layers, 0):
            raise AssertionError(f"e2e_options dpm launches {dpm_counts}")
        out["dpm"] = {"wall_s": wall_s, "denoise_step_s": pipe.timings["denoise_step_s"],
                      "decode_s": pipe.timings["decode_s"], "launches": dpm_counts,
                      "output_mean": float(video.mean()), "output_std": float(video.std())}

        fused = pipe.generate(output_type="latent", **kw)
        fused_steps = pipe.timings["denoise_step_s"]
        reset_counts()
        segmented = pipe.generate(output_type="latent", segment_steps=1, **kw)
        seg_counts = read_counts()
        if not torch.equal(segmented, fused):
            raise AssertionError(f"e2e_options: segment_steps=1 latents differ from the whole loop's: "
                                 f"{(segmented.float() - fused.float()).abs().max().item()}")
        out["segmented"] = {"bitwise_equal": True, "whole_step_s": fused_steps,
                            "segmented_step_s": pipe.timings["denoise_step_s"],
                            "flash_attention_launches": seg_counts["flash_attention"]}

        seen = []

        def stop(step, _latents):
            seen.append(step)
            return False

        reset_counts()
        stopped = pipe.generate(output_type="latent", segment_steps=1, callback_on_segment_end=stop, **kw)
        stop_counts = read_counts()
        if seen != [1] or pipe.stats["steps_run"] != 1 or not torch.isfinite(stopped.float()).all():
            raise AssertionError(f"e2e_options: the stopping callback saw {seen}, ran {pipe.stats}")
        if cuda and not check_counts(stop_counts, backend, layers, 0):
            raise AssertionError(f"e2e_options: the stopped run's launches {stop_counts}")
        out["callback_stop"] = {"segments_seen": seen, "steps_run": pipe.stats["steps_run"],
                                "flash_attention_launches": stop_counts["flash_attention"]}

        threshold = 0.02
        host = int(np.sum(guidance_schedule(6.0, 2, True) - np.float32(1.0) < np.float32(threshold)))
        reset_counts()
        pipe.generate(output_type="latent", use_dynamic_cfg=True, cfg_skip_threshold=threshold, **kw)
        skip_counts = read_counts()
        want_by_batch = {k: v for k, v in (("1", layers * host), ("2", layers * (2 - host))) if v}
        if pipe.stats["cfg_skipped_steps"] != host or host != 1:
            raise AssertionError(f"e2e_options cfg-skip: {pipe.stats} against {host} from the guidance table")
        if cuda and (skip_counts["flash_attention_by_batch"] != want_by_batch or skip_counts["reruns"]):
            raise AssertionError(f"e2e_options cfg-skip launches {skip_counts}; expected by batch {want_by_batch}")
        out["cfg_skip"] = {"threshold": threshold, "skipped_steps": host, "denoise_step_s": pipe.timings["denoise_step_s"],
                           "flash_attention_by_batch": skip_counts["flash_attention_by_batch"]}

        reset_peak()
        t0 = time.perf_counter()
        untiled = pipe.decode_latents(fused)
        untiled_s, untiled_peak = time.perf_counter() - t0, peak_gb()
        reset_peak()
        t0 = time.perf_counter()
        z = fused.to(pipe.vae_cfg.dtype) / pipe.vae_cfg.scaling_factor
        lean = denormalize_video(pipe._decode_lean_tiles(z).float().cpu().numpy())
        lean_s, lean_peak = time.perf_counter() - t0, peak_gb()
        _clip_checks(lean, untiled.shape, "e2e_options lean decode")
        out["lean_decode"] = {"untiled_s": untiled_s, "untiled_peak_gb": untiled_peak, "lean_s": lean_s,
                              "lean_peak_gb": lean_peak, "psnr_db_vs_untiled": psnr(lean, untiled),
                              "max_abs_diff": float(np.abs(lean - untiled).max())}
    finally:
        pipe.attention_backend, pipe.transformer_cfg = saved
    emit(out)
    return dpm_counts


def phase_turbo(dev, pipe, backend="flash", height=480, width=720, num_frames=49, steps=50):
    """The first timed 50-step clips of the port: two ``generate`` calls,
    dynamic guidance 6, seed 42 (the same latents and ref draws), T5 run in
    each (the prompt cache cleared first): exact (``backend``, B1), and the
    JAX package's turbo knobs (``BENCH_r05.json`` ``parsed.turbo.knobs``):
    int8 linears (quantized on the card), ``windowed`` w = 1 (B4, with B1
    online for the global queries), cfg-skip 0.02, adaptive 0.05 and
    segments of 6 steps.  Each clip's seconds (T5 + ref encode + steps +
    decode), step times, peak memory, skip counts and launches; the frame
    PSNR of turbo against exact (a finding on random weights, beside the
    JAX package's 35 dB gate).  Runs on the CPU at a tiny size too."""
    import torch

    from s2v_torch.pipelines.denoise import guidance_schedule
    from s2v_torch.utils.video import psnr

    cuda, layers = dev.type == "cuda", pipe.transformer_cfg.num_layers
    image = np.clip(np.random.RandomState(42).randn(height, width, 3).astype(np.float32) * 0.5, -1, 1)
    kw = dict(prompt="a pig walking in the park", ref_image=image, height=height, width=width,
              num_frames=num_frames, num_inference_steps=steps, guidance_scale=6.0, use_dynamic_cfg=True, seed=42)
    cfg_skip, adaptive, segment = 0.02, 0.05, 6
    host_skips = int(np.sum(guidance_schedule(6.0, steps, True) - np.float32(1.0) < np.float32(cfg_skip)))

    def clip(name, **extra):
        pipe._prompt_embed_cache.clear()  # the clip's time includes T5
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        video = pipe.generate(**kw, **extra)
        seconds = time.perf_counter() - t0
        counts, t = read_counts(), pipe.timings
        _clip_checks(video, (1, num_frames, height, width, 3), f"turbo: the {name} clip")
        return video, {"seconds": seconds, "encode_prompt_s": t["encode_prompt_s"], "encode_ref_s": t["encode_ref_s"],
                       "denoise_s": sum(t["denoise_step_s"]), "denoise_step_s": t["denoise_step_s"],
                       "decode_s": t["decode_s"], **pipe.stats, "launches": counts,
                       "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9 if cuda else None,
                       "output_mean": float(video.mean()), "output_std": float(video.std())}

    saved = (pipe.attention_backend, pipe.transformer_cfg, pipe.transformer_params)
    try:
        pipe.set_attention(backend)
        exact, exact_line = clip("exact")
        pipe.transformer_params, quantize_s = _quantized(pipe)
        pipe.set_attention("windowed", 1)
        turbo, turbo_line = clip("turbo", cfg_skip_threshold=cfg_skip, adaptive_threshold=adaptive,
                                 segment_steps=segment)
    finally:
        pipe.attention_backend, pipe.transformer_cfg, pipe.transformer_params = saved
        if cuda:
            # the int8 tree and the B=1 and B=2 activations leave the allocator's cache
            # fragmented: without this the next phase's train steps wait on its
            # reorganisation (a quarter of a profiled exact train step idle on an H100)
            torch.cuda.empty_cache()
    problems = []
    if turbo_line["cfg_skipped_steps"] != host_skips:
        problems.append(f"cfg-skipped steps {turbo_line['cfg_skipped_steps']}, the guidance table has {host_skips}")
    if cuda:
        if not check_counts(exact_line["launches"], backend, layers * steps, 0):
            problems.append(f"exact launches {exact_line['launches']}")
        c = turbo_line["launches"]
        computed = steps - turbo_line["adaptive_skipped_steps"]
        by_batch = {b: n // layers for b, n in c["flash_attention_by_batch"].items()}
        if not (c["banded_flash_attention"] == c["flash_attention"] == layers * computed and not c["reruns"]
                and sum(by_batch.values()) == computed and by_batch.get("1", 0) <= host_skips
                and by_batch.get("2", 0) <= steps - host_skips):
            problems.append(f"turbo launches {c} for {computed} computed steps")
        turbo_line["computed_steps_by_batch"] = by_batch
    if problems:
        raise AssertionError(f"turbo: {problems}")
    line = {"phase": "turbo", "steps": steps, "num_frames": num_frames,
            "knobs": {"linears": "int8", "attention": "windowed", "window": 1, "cfg_skip_threshold": cfg_skip,
                      "adaptive_threshold": adaptive, "segment_steps": segment},
            "host_cfg_skip_steps": host_skips, "quantize_s": quantize_s, "exact": exact_line, "turbo": turbo_line,
            "speedup": exact_line["seconds"] / turbo_line["seconds"],
            "frame_psnr_db_turbo_vs_exact": psnr(turbo, exact), "jax_psnr_gate_db": 35.0}
    emit(line)
    return {"exact": exact_line["launches"], "turbo": turbo_line["launches"]}


def _variant_clip(name, pipe, fn, steps_run, shape, *args, **kw):
    """One variant's clip: the clip's gates (``shape``, finite, in [0, 1]),
    B1's launches (one per block and step run, all at B=2 in the model's
    type) and its seconds split into encode, steps and decode.  On the CPU
    (a rehearsal at a tiny size) no kernel launches and no memory is read."""
    import torch

    cuda = pipe.device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    video = fn(pipe, *args, **kw)
    wall_s = time.perf_counter() - t0
    counts = read_counts()
    _clip_checks(video, shape, name)
    layers = pipe.transformer_cfg.num_layers
    dtype = str(pipe.transformer_cfg.dtype).replace("torch.", "")
    if cuda and (not check_counts(counts, "flash", steps_run * layers, 0) or counts["flash_attention_by_dtype"] != {
            dtype: steps_run * layers + counts["reruns"]}):
        raise AssertionError(f"{name}: launches {counts}; expected {steps_run * layers} B1 ({dtype})")
    if cuda and (counts["qk_norm_rope_by_dtype"] != {dtype: steps_run * layers} or counts["qk_norm_rope_plain"]):
        raise AssertionError(f"{name}: qk_norm_rope launches {counts['qk_norm_rope_by_dtype']}, plain calls "
                             f"{counts['qk_norm_rope_plain']}; expected {steps_run * layers} ({dtype}) and 0")
    if len(pipe.timings["denoise_step_s"]) != steps_run:
        raise AssertionError(f"{name}: ran {len(pipe.timings['denoise_step_s'])} steps, expected {steps_run}")
    t = pipe.timings
    encode_s = t.get("encode_prompt_s", 0.0) + t.get("encode_s", 0.0) + t.get("encode_ref_s", 0.0)
    return {"wall_s": wall_s, "encode_s": encode_s, "denoise_step_s": t["denoise_step_s"],
            "steps_s": sum(t["denoise_step_s"]), "decode_s": t["decode_s"], "launches": counts,
            "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9 if cuda else None,
            "output_mean": float(video.mean()), "output_std": float(video.std())}


def phase_variants(dev, pipe, backend="flash", height=480, width=720, num_frames=49, steps=2):
    """The pipeline variants on the full-width 5b pipeline at 49x480x720,
    each ``steps`` steps run: ``generate_i2v`` and ``generate_fun_control``
    on an I2V transformer (the 5b one with a seeded 32-channel
    ``patch_embed.proj``, the only tensor ``in_channels`` changes; out 16,
    as CogVideoX-5b-I2V publishes), ``generate_v2v`` at strength 0.8 on a
    seeded 49-frame video (``steps`` + 1 scheduled, the last ``steps`` run),
    and ``generate`` with disentangled modulation (each block's norm1/norm2
    linear moved by a seeded rank-128 delta, the old one kept as
    ``base_linear``).  Runs before ``pretrained`` empties the pipeline; on
    the CPU at a tiny size too (the adapter's rank capped by the width)."""
    import dataclasses

    import torch

    from s2v_torch.pipelines import generate_fun_control, generate_i2v, generate_v2v

    cfg = pipe.transformer_cfg
    rng = np.random.RandomState(43)
    image = np.clip(rng.randn(height, width, 3).astype(np.float32) * 0.5, -1, 1)
    video = np.clip(rng.randn(num_frames, height, width, 3).astype(np.float32) * 0.5, -1, 1)
    shape = (1, num_frames, height, width, 3)
    size = dict(height=height, width=width, num_frames=num_frames)
    prompt = "a pig walking in the park"
    saved = pipe.attention_backend
    pipe.set_attention(backend)
    gen = torch.Generator(device=dev).manual_seed(5)
    # (noise | condition): twice the VAE's latent channels, 32 for the CogVideoX VAE
    d, pp, c_in = cfg.inner_dim, cfg.patch_size ** 2, 2 * pipe.vae_cfg.latent_channels
    params = pipe.transformer_params
    proj = {"weight": torch.empty((d, pp * c_in), dtype=cfg.dtype, device=dev).normal_(0.0, 0.02, generator=gen),
            "bias": torch.zeros(d, dtype=cfg.dtype, device=dev)}
    i2v_pipe = dataclasses.replace(
        pipe, transformer_params={**params, "patch_embed": {**params["patch_embed"], "proj": proj}},
        transformer_cfg=dataclasses.replace(cfg, in_channels=c_in))
    out = {"phase": "variants", "backend": backend, "num_frames": num_frames, "steps": steps}
    try:
        out["i2v"] = _variant_clip("variants i2v", i2v_pipe, generate_i2v, steps, shape, prompt, image,
                                   num_inference_steps=steps, seed=42, **size)
        out["fun_control"] = _variant_clip("variants fun_control", i2v_pipe, generate_fun_control, steps, shape,
                                           prompt, video, num_inference_steps=steps, seed=42)
        del i2v_pipe, proj
        out["v2v"] = _variant_clip("variants v2v", pipe, generate_v2v, steps, shape, prompt, video, strength=0.8,
                                   num_inference_steps=steps + 1, seed=42)
        rank = min(LORA_RANK, cfg.time_embed_dim)

        def adapted(linear):
            a = torch.empty((rank, linear["weight"].shape[1]), device=dev).normal_(0.0, LORA_STD, generator=gen)
            b = torch.empty((linear["weight"].shape[0], rank), device=dev).normal_(0.0, LORA_STD, generator=gen)
            return {"weight": (linear["weight"].float() + 0.5 * (b @ a)).to(linear["weight"].dtype),
                    "bias": linear["bias"]}

        blocks = [{**layer, **{n: {**layer[n], "base_linear": layer[n]["linear"], "linear": adapted(layer[n]["linear"])}
                               for n in ("norm1", "norm2")}} for layer in params["blocks"]]
        dis_pipe = dataclasses.replace(pipe, transformer_params={**params, "blocks": blocks},
                                       transformer_cfg=dataclasses.replace(cfg, disentangled_modulation=True))
        out["disentangled"] = _variant_clip(
            "variants disentangled generate", dis_pipe, lambda p, **kw: p.generate(**kw), steps, shape, prompt=prompt,
            ref_image=image, num_inference_steps=steps, seed=42, **size)
        del dis_pipe, blocks
    finally:
        pipe.attention_backend = saved
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    emit(out)
    return out


def build_2b_pipe(dev):
    """The CogVideoX-2b pipeline (``TransformerConfig.cogvideox_2b()``: 30
    blocks, 30 heads x 64, sincos positions) with T5-XXL and the CogVideoX
    VAE, all fp16, random weights from fixed seeds.  T5's fp16 prompt
    embeddings are checked: if they overflow (the port, like the JAX
    package, has no activation clamp), T5 is rebuilt on the host in fp32
    (``text_encoder_device="host"``) and the line says so."""
    import torch

    from s2v_torch import S2VPipeline, T5Config, TransformerConfig, VAEConfig
    from s2v_torch.models.t5 import init_t5_params_random
    from s2v_torch.models.transformer import init_transformer_params_random
    from s2v_torch.models.vae import init_vae_params_random

    fp16 = torch.float16
    t0 = time.perf_counter()
    tcfg = TransformerConfig.cogvideox_2b()
    pipe = S2VPipeline(
        transformer_params=init_transformer_params_random(tcfg, seed=10, device=dev), transformer_cfg=tcfg,
        vae_params=init_vae_params_random(VAEConfig(dtype=fp16), seed=12, device=dev), vae_cfg=VAEConfig(dtype=fp16),
        t5_params=init_t5_params_random(T5Config(dtype=fp16), seed=11, device=dev), t5_cfg=T5Config(dtype=fp16),
        tokenizer=smoke_tokenizer(), device=dev,
    )
    emb = pipe.encode_prompt("a pig walking in the park")
    line = {"phase": "init_2b", "config": "cogvideox_2b", "dtype": "float16", "num_layers": tcfg.num_layers,
            "heads": tcfg.num_attention_heads, "use_rotary_positional_embeddings": tcfg.use_rotary_positional_embeddings,
            "t5_fp16_finite": bool(torch.isfinite(emb).all()), "t5_fp16_max_abs": float(emb.float().abs().max())}
    if not line["t5_fp16_finite"]:
        pipe.t5_params = init_t5_params_random(T5Config(dtype=torch.float32), seed=11, device="cpu")
        pipe.t5_cfg, pipe.t5_on_host = T5Config(dtype=torch.float32), True
        pipe._prompt_embed_cache.clear()
        line["text_encoder_device"] = "host"
    torch.cuda.synchronize()
    line.update(init_s=time.perf_counter() - t0, weights_gb=torch.cuda.memory_allocated() / 1e9)
    emit(line)
    return pipe


def phase_e2e_2b(dev, pipe, backend="flash", height=480, width=720, num_frames=49):
    """The 2b family at 49x480x720, 2 steps each: ``generate_t2v`` (the
    sincos table over [text | video]) and ``generate`` (s2v; the table over
    [text | video], none for the ref), fp16 B1 30 per step at B=2; then one
    more t2v step under ``torch.profiler`` (on CUDA; the CPU rehearses the
    rest at a tiny size)."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from s2v_torch.pipelines import generate_t2v

    pipe.set_attention(backend)
    image = np.clip(np.random.RandomState(42).randn(height, width, 3).astype(np.float32) * 0.5, -1, 1)
    prompt = "a pig walking in the park"
    size = dict(height=height, width=width, num_frames=num_frames)
    shape = (1, num_frames, height, width, 3)
    out = {"phase": "e2e_2b", "backend": backend, "config": "cogvideox_2b",
           "dtype": str(pipe.transformer_cfg.dtype).replace("torch.", ""),
           "steps": 2}
    out["t2v"] = _variant_clip("e2e_2b t2v", pipe, generate_t2v, 2, shape, prompt, num_inference_steps=2, seed=42,
                               **size)
    out["s2v"] = _variant_clip("e2e_2b s2v", pipe, lambda p, **kw: p.generate(**kw), 2, shape, prompt=prompt,
                               ref_image=image, num_inference_steps=2, seed=42, **size)
    if dev.type == "cuda":
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            generate_t2v(pipe, prompt, num_inference_steps=1, seed=42, output_type="latent", **size)
        out["profiled_t2v_step"] = {"step_s": pipe.timings["denoise_step_s"][0], **device_breakdown(prof)}
    # the opt-ins on fp16 kernels B3, B4 and B6: one s2v step each, to latents
    out["opt_ins"] = _opt_in_steps_2b(dev, pipe, prompt, image, size)
    emit(out)
    runs = (out["t2v"]["launches"], out["s2v"]["launches"])
    by_dtype = {}
    for run in runs:
        for dtype, n in run["flash_attention_by_dtype"].items():
            by_dtype[dtype] = by_dtype.get(dtype, 0) + n
    return {**{k: sum(run[k] for run in runs) for k in ATTENTION_KERNELS + ("qk_norm_rope", "adaln")},
            "flash_attention_by_dtype": by_dtype, "opt_ins": out["opt_ins"]}


def _opt_in_steps_2b(dev, pipe, prompt, image, size):
    """One s2v step (to latents) on the fp16 2b pipeline with each opt-in
    whose kernel now takes fp16: ``windowed`` (w = 2; fp16 B4 and B1 for
    the global queries), ``sp_windowed`` on the one-rank seq mesh (fp16 B6;
    on CUDA only, the mesh is NCCL's) and the int8 DiT with ``flash_int8``
    (fp16 B3).  Each runs its kernel once per block in fp16, none in bf16,
    and gives finite latents.  The backend, the mesh and the fp16 tree are
    restored after."""
    L = pipe.transformer_cfg.num_layers
    kw = dict(prompt=prompt, ref_image=image, num_inference_steps=1, seed=42, output_type="latent", **size)
    runs = [("windowed", "banded_flash_attention"), ("flash_int8", "flash_attention_qk_int8")]
    if dev.type == "cuda":
        runs.insert(1, ("sp_windowed", "banded_flash_attention_local"))
    saved = (pipe.attention_backend, pipe.transformer_cfg, pipe.transformer_params)
    out = {}
    try:
        for backend, kernel in runs:
            if backend == "sp_windowed":
                pipe.set_mesh(sp_mesh())
            if backend == "flash_int8":
                pipe.transformer_params, out["quantize_s"] = _quantized(pipe)
            pipe.set_attention(backend, 2)
            reset_counts()
            t0 = time.perf_counter()
            latents = pipe.generate(**kw)
            seconds = time.perf_counter() - t0
            counts = read_counts()
            pipe.set_mesh(None)
            pipe.attention_backend, pipe.transformer_cfg, pipe.transformer_params = saved
            if not bool(latents.isfinite().all()):
                raise AssertionError(f"e2e_2b {backend}: latents are not finite")
            if dev.type == "cuda" and (not check_counts(counts, backend, L, 0)
                                       or counts[f"{kernel}_by_dtype"] != {"float16": L}):
                raise AssertionError(f"e2e_2b {backend}: launches {counts}; expected fp16 {kernel} {L} times")
            out[backend] = {"seconds": seconds, "step_s": pipe.timings["denoise_step_s"][0], "launches": counts}
    finally:
        pipe.set_mesh(None)
        pipe.attention_backend, pipe.transformer_cfg, pipe.transformer_params = saved
    return out


def phase_train_2b(dev, pipe, backend="flash", steps=3):
    """The LoRA step of ``train`` on the 2b pipeline (rank 128 on the seven
    target families, fp16 model, fp32 adapters and adamw state): losses
    finite, base weights unchanged, per step fp16 B1 60 (forward and remat
    recompute) and fp16 B2 30.  The batch carries the sincos table.  A
    gradient that underflows in fp16 (no loss scaler, as in the JAX
    package) shows as adapters whose b stays zero: printed, not gated.
    The first backward of step 0 (the last block's attention) keeps its
    inputs; after the steps, B2 is held to its plain version at that dO,
    with the shares of gradients and of dS that fp16 flushes."""
    from s2v_torch.ops import attention as attention_module
    from s2v_torch.training.lora import LoRASpec
    from s2v_torch.training.optim import OptimizerSpec

    opt = OptimizerSpec(optimizer="adamw", learning_rate=1e-4, beta1=0.9, beta2=0.95, weight_decay=1e-4,
                        epsilon=1e-8, max_grad_norm=1.0, moment_dtype="bfloat16")
    bwd, kept = attention_module.flash_attention_bwd, []

    def keep_first(*args):
        if not kept:
            kept.extend(a.detach().clone() for a in args)
        return bwd(*args)

    attention_module.flash_attention_bwd = keep_first
    try:
        r = train_steps(pipe, dev, 480, 720, 49, steps, LoRASpec(rank=128, alpha=64.0), opt, backend)
    finally:
        attention_module.flash_attention_bwd = bwd
    L = pipe.transformer_cfg.num_layers
    problems = []
    if r["batch_shape"] != [1, 13, 60, 90, 16]:
        problems.append(f"batch {r['batch_shape']}")
    if not all(np.isfinite(r["losses"])):
        problems.append(f"losses {r['losses']}")
    if not r["base_unchanged"]:
        problems.append("a base parameter changed")
    for i, c in enumerate(r["launches"]):
        if (not check_counts(c, backend, 2 * L, L) or c["flash_attention_by_dtype"] != {"float16": 2 * L + c["reruns"]}
                or c["flash_attention_bwd_by_dtype"] != {"float16": L}):
            problems.append(f"step {i} launches {c}")
    if problems:
        raise AssertionError(f"train_2b: {problems}; {r}")
    if dev.type == "cuda":
        r["step_do"] = _bwd_at_small_do(*kept, "train_2b: B2 at the step's own dO")
    del kept
    r["opt_ins"] = _opt_in_train_steps_2b(dev, pipe, opt)
    emit({"phase": "train_2b", "backend": backend, "config": "cogvideox_2b", "dtype": "float16", "steps": steps, **r})
    return r


def _opt_in_train_steps_2b(dev, pipe, opt, height=480, width=720, num_frames=49):
    """One LoRA step of ``train_2b`` with ``windowed`` (fp16 B4 forward, B5
    backward, their global queries through fp16 B1/B2) and, on CUDA, one
    with ``sp_windowed`` under the one-rank seq mesh's context (fp16 B6,
    B7): losses finite, base unchanged, each kernel in fp16 once per block
    per forward and per backward (and the remat recompute)."""
    import contextlib
    import dataclasses

    from s2v_torch.parallel import default_logical_map, mesh_context
    from s2v_torch.training.lora import LoRASpec

    L = pipe.transformer_cfg.num_layers
    saved = pipe.transformer_cfg
    pipe.transformer_cfg = dataclasses.replace(saved, attention_window_frames=2)
    out = {}
    try:
        for backend, fwd, bwd in (("windowed", "banded_flash_attention", "banded_flash_attention_bwd"),
                                  ("sp_windowed", "banded_flash_attention_local", "banded_flash_attention_local_bwd")):
            if backend == "sp_windowed" and dev.type != "cuda":
                continue
            mesh = sp_mesh() if backend == "sp_windowed" else None
            with mesh_context(mesh, default_logical_map(mesh)) if mesh is not None else contextlib.nullcontext():
                r = train_steps(pipe, dev, height, width, num_frames, 1, LoRASpec(rank=128, alpha=64.0), opt, backend,
                                profile=False)
            c = r["launches"][0]
            if not (all(np.isfinite(r["losses"])) and r["base_unchanged"]):
                raise AssertionError(f"train_2b {backend}: {r}")
            if dev.type == "cuda" and (not check_counts(c, backend, 2 * L, L) or c[f"{fwd}_by_dtype"] != {
                    "float16": 2 * L} or c[f"{bwd}_by_dtype"] != {"float16": L}):
                raise AssertionError(f"train_2b {backend}: launches {c}")
            out[backend] = {k: r[k] for k in ("losses", "step_s", "launches", "max_memory_allocated_gb")}
    finally:
        pipe.transformer_cfg = saved
    return out



# remat "dots" keeps every linear's output of all 42 blocks (at 49 frames
# ~1.6 GB a block with the adapters' products, ~69 GB, which does not fit
# beside the resident T5 and DiT on an 80 GB card): train_remat runs its
# three steps on a 25-frame clip (7 latent frames, 11,026 tokens)
REMAT_FRAMES = 25


def _lora_batch(pipe, height, width, num_frames, seed=7):
    """One seeded clip through ``latent_batches``, with the positions the
    model samples with (the RoPE tables, or the 2b sincos table)."""
    from s2v_torch.training.data import latent_batches

    rng = np.random.RandomState(seed)
    item = {"video": np.clip(rng.randn(num_frames, height, width, 3) * 0.5, -1, 1).astype(np.float32),
            "ref_image": np.clip(rng.randn(height, width, 3) * 0.5, -1, 1).astype(np.float32),
            "prompt": "a pig walking in the park"}
    key = (id(pipe.vae_params), height, width, num_frames)  # seed 7 is train_steps' clip: its cache serves
    if seed == 7 and key in _TRAIN_BATCHES:
        batch = dict(_TRAIN_BATCHES[key])
    else:
        batch = next(latent_batches([item], pipe, batch_size=1, seed=0))
        if seed == 7:
            _TRAIN_BATCHES[key] = dict(batch)
    cos, sin = pipe.prepare_rope(height, width, batch["video_latents"].shape[1])
    if cos is not None:
        batch["rope_cos"], batch["rope_sin"] = cos, sin
    table = pipe.prepare_pos_embedding(height, width, num_frames)
    if table is not None:
        batch["pos_embedding"] = table
    return batch


def phase_train_remat(dev, pipe, backend="flash", num_frames=REMAT_FRAMES, height=480, width=720):
    """One LoRA step of the full-width 5b DiT (rank 128, the ``train``
    phase's optimizer) with each remat mode of the trainer, ``full``,
    ``dots`` (the linears' outputs kept) and ``seg`` (nested checkpoints,
    6 segments of 7 blocks), from the same adapters, batch and draws on a
    ``num_frames`` clip: seconds, ``max_memory_allocated`` and launches of
    each (B1 once per forward: 2 per block with full and dots; with seg 3
    per block less one a segment, since the non-reentrant checkpoint stops a
    segment's recompute once it has the inputs of its last block; B2 once
    per block).  The three losses are the same forward's: equal."""
    import torch

    from s2v_torch.models.transformer import _remat_plan
    from s2v_torch.training.lora import LoRASpec, init_lora_params, make_lora_train_step
    from s2v_torch.training.optim import OptimizerSpec

    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    batch = _lora_batch(pipe, height, width, num_frames)
    params, cfg = pipe.transformer_params, pipe.transformer_cfg
    L = cfg.num_layers
    spec = LoRASpec(rank=128, alpha=64.0)
    opt = OptimizerSpec(optimizer="adamw", learning_rate=1e-4, beta1=0.9, beta2=0.95, weight_decay=1e-4,
                        epsilon=1e-8, max_grad_norm=1.0, moment_dtype="bfloat16")
    modes, b_after = {}, {}
    segments = _remat_plan("seg", L)[1]
    # a warm-up step (untimed): the first step after the pipeline's build pays for allocations
    lora = init_lora_params(torch.Generator(device=dev).manual_seed(1), params, spec)
    init, step = make_lora_train_step(params, cfg, spec, attention_backend=backend, optimizer_spec=opt)
    step(lora, init(lora), batch, torch.Generator(device=dev).manual_seed(3))
    del lora, init, step
    for mode, forwards in (("full", 2 * L), ("dots", 2 * L), ("seg", 3 * L - segments)):
        lora = init_lora_params(torch.Generator(device=dev).manual_seed(1), params, spec)
        init, step = make_lora_train_step(params, cfg, spec, attention_backend=backend,
                                          remat=True if mode == "full" else mode, optimizer_spec=opt)
        state = init(lora)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        reset_counts()
        sync()
        t0 = time.perf_counter()
        lora, state, loss = step(lora, state, batch, torch.Generator(device=dev).manual_seed(3))
        sync()
        seconds = time.perf_counter() - t0
        counts = read_counts()
        if dev.type == "cuda" and not check_counts(counts, backend, forwards, L):
            raise AssertionError(f"train_remat {mode}: launches {counts}; expected B1 {forwards}, B2 {L}")
        modes[mode] = {"seconds": seconds, "loss": loss.item(), "launches": counts,
                       "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9 if dev.type == "cuda"
                       else None}
        b_after[mode] = lora["qkv"]["b"].detach().float().clone()
        del lora, state, step
    losses = {m: r["loss"] for m, r in modes.items()}
    if not all(np.isfinite(list(losses.values()))) or len(set(losses.values())) != 1:
        raise AssertionError(f"train_remat: the three modes' losses differ: {losses}")
    update_diff = {m: (b_after[m] - b_after["full"]).abs().max().item() for m in ("dots", "seg")}
    line = {"phase": "train_remat", "backend": backend, "num_frames": num_frames,
            "batch_shape": list(batch["video_latents"].shape), "modes": modes, "losses_equal": True,
            "qkv_b_max_diff_vs_full": update_diff, "qkv_b_max": b_after["full"].abs().max().item()}
    emit(line)
    return {**line, "launches": [modes[m]["launches"] for m in modes]}


def write_smoke_clips(height=480, width=720, num_frames=49, clips=2):
    """The trainer's dataset in ``build/smoke_clips``: ``clips`` seeded
    ``num_frames`` x ``height`` x ``width`` mp4s written with OpenCV, a
    ``prompts.txt`` and a ``_ref.png`` subject for the first."""
    import cv2

    root = REPO / "build" / "smoke_clips"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    for i in range(clips):
        rng = np.random.RandomState(20 + i)
        writer = cv2.VideoWriter(str(root / f"clip{i}.mp4"), cv2.VideoWriter_fourcc(*"mp4v"), 8, (width, height))
        if not writer.isOpened():
            raise RuntimeError("OpenCV cannot write mp4v here")
        base = rng.rand(height // 8, width // 8, 3)
        for f in range(num_frames):  # a drifting smooth pattern: decodable, not white noise
            frame = np.roll(base, f, axis=1).repeat(8, 0).repeat(8, 1)
            writer.write((np.clip(frame + 0.1 * rng.rand(height, width, 3), 0, 1) * 255).astype(np.uint8))
        writer.release()
    (root / "prompts.txt").write_text("<cls> a pig walking in the park\n<cls> a cat on a beach\n")
    write_png(root / "clip0_ref.png", (np.random.RandomState(30).rand(height, width, 3) * 255).astype(np.uint8))
    return root


# wraps python -m s2v_torch.train in its subprocess: per train step its
# seconds (after a device sync), loss and every kernel's launches; the
# load and encode seconds; the peak device memory; printed as one JSON line
_TRAIN_CLI_WRAPPER = """
import json, runpy, sys, time
import torch
sys.argv = ["s2v_torch.train"] + sys.argv[1:]
from s2v_torch.pipelines import s2v as P
from s2v_torch.training import data as D, lora as L
from chip_smoke import ATTENTION_KERNELS, read_counts
cuda = torch.cuda.is_available()
sync = torch.cuda.synchronize if cuda else (lambda: None)
rec = {"load_s": 0.0, "encode_s": 0.0, "step_s": [], "losses": [], "launches": []}
load, encode, make = P.S2VPipeline.from_pretrained, D._encode_moments, L.make_lora_train_step
def timed_load(*a, **k):
    t = time.perf_counter(); pipe = load(*a, **k); sync(); rec["load_s"] += time.perf_counter() - t
    return pipe
def timed_encode(*a, **k):
    t = time.perf_counter(); out = encode(*a, **k); sync(); rec["encode_s"] += time.perf_counter() - t
    return out
def timed_make(*a, **k):
    init, step = make(*a, **k)
    def timed_step(*args, **kw):
        sync(); before = read_counts()
        t = time.perf_counter()
        out = step(*args, **kw)
        sync()
        rec["step_s"].append(time.perf_counter() - t); rec["losses"].append(out[2].item())
        after = read_counts()
        rec["launches"].append({n: after[n] - before[n]
                                for n in ATTENTION_KERNELS + ("reruns", "flash_attention_qk_int8_prepass")})
        return out
    return init, timed_step
P.S2VPipeline.from_pretrained = staticmethod(timed_load)
D._encode_moments = timed_encode
L.make_lora_train_step = timed_make
if cuda:
    torch.cuda.reset_peak_memory_stats()
t0 = time.perf_counter()
runpy.run_module("s2v_torch.train", run_name="__main__")
total = read_counts()
rec.update(seconds=time.perf_counter() - t0,
           max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9 if cuda else None,
           flash_attention_total=total["flash_attention"] - total["reruns"])
print(json.dumps({"train_cli": rec}))
"""


def _run_train_cli(args, log):
    """``python3 -m s2v_torch.train`` (through the wrapper) in a subprocess;
    its record, or raise with the log's tail."""
    code = _TRAIN_CLI_WRAPPER
    t0 = time.perf_counter()
    with open(log, "w") as logf:
        proc = subprocess.run([sys.executable, "-c", code, *args], cwd=str(REPO), stdout=subprocess.PIPE,
                              stderr=logf, text=True, timeout=900, env=dict(os.environ, PYTHONPATH=str(REPO)))
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith('{"train_cli"')]
    if proc.returncode != 0 or not lines:
        raise AssertionError(f"train_cli: exit {proc.returncode}\n{proc.stdout[-2000:]}\n{_tail(Path(log))}")
    return {**json.loads(lines[-1])["train_cli"], "wall_s": time.perf_counter() - t0}


def _files(root: Path) -> dict:
    return {str(p.relative_to(root)): p.stat().st_size for p in sorted(root.rglob("*")) if p.is_file()}


def phase_train_cli(dev, pipe, backend="flash"):
    """The trainer as users run it: ``python3 -m s2v_torch.train`` in a
    subprocess on the 5b snapshot that ``pretrained`` wrote (written here
    from ``pipe`` when that phase did not run), over two seeded 49x480x720
    clips (``build/smoke_clips``): LoRA rank 128 / alpha 64, no accumulation,
    cosine with 1 warm-up step, clip 1.0, the encode cache on disk, a train
    state every step, 2 optimizer steps, validation (a 1-step ``generate``
    through the merged adapters) at step 2.  Then a second run resumes from
    ``train_state_1`` to step 2 (its encodes from the disk cache): its
    adapters and optimizer state against the first run's at step 2.  Per
    run: load, encode and per-step seconds, peak memory, launches per step
    (B1 twice and B2 once per block), the files written; the resumed run
    validates nothing (the first run's validation covers it).  Deletes the
    snapshot, the clips and the outputs after."""
    import torch

    from s2v_torch.loaders.safetensors_io import load_safetensors

    build = REPO / "build"
    snap = build / "smoke_snapshot"
    written = None
    if not snap.is_dir():
        written = write_smoke_snapshot(pipe)
    release_pipe(pipe, dev)  # the trainer needs the card
    clips = write_smoke_clips()
    out1, out2, cache = build / "smoke_train", build / "smoke_train_resumed", build / "smoke_encode_cache"
    for d in (out1, out2, cache):
        shutil.rmtree(d, ignore_errors=True)
    common = ["--pretrained_model_name_or_path", str(snap), "--dataset_dir", str(clips), "--rank", "128",
              "--lora_alpha", "64", "--gradient_accumulation_steps", "1", "--lr_scheduler", "cosine",
              "--lr_warmup_steps", "1", "--max_grad_norm", "1.0", "--encode_cache_dir", str(cache),
              "--checkpointing_steps", "1", "--max_train_steps", "2", "--validation_steps", "2",
              "--validation_num_inference_steps", "1", "--validation_prompt", "<cls> a pig walking in the park",
              "--height", "480", "--width", "720", "--max_num_frames", "49", "--device", dev.type]
    L = 42
    try:
        first = _run_train_cli([*common, "--output_dir", str(out1)], build / "smoke_train.log")
        # the resumed run without validation: the first run's covers it
        resumed = [a for i, a in enumerate(common) if not (a.startswith("--validation") or (
            i and common[i - 1].startswith("--validation")))]
        second = _run_train_cli([*resumed, "--output_dir", str(out2), "--resume_from_checkpoint",
                                 str(out1 / "train_state_1")], build / "smoke_train_resumed.log")
        files = _files(out1)
        want = {"pytorch_lora_weights_transformer.safetensors", "samples/step2_p0_v0.mp4",
                "train_state_1/tensors.safetensors", "train_state_1/tree.json", "train_state_2/tensors.safetensors",
                "train_state_2/tree.json"}
        problems = []
        if set(files) != want or not all(files.values()):
            problems.append(f"files {files}")
        for name, r, n in (("first", first, 2), ("resumed", second, 1)):
            if len(r["step_s"]) != n or not all(np.isfinite(r["losses"])):
                problems.append(f"{name}: {len(r['step_s'])} micro-steps, losses {r['losses']}")
            for c in r["launches"]:
                if dev.type == "cuda" and not check_counts(c, backend, 2 * L, L):
                    problems.append(f"{name} launches {c}")
        a = load_safetensors(str(out1 / "train_state_2" / "tensors.safetensors"))
        b = load_safetensors(str(out2 / "train_state_2" / "tensors.safetensors"))
        if sorted(a) != sorted(b):
            problems.append("the resumed state has other tensors")
        on_dev = lambda t: t.to(dev)  # noqa: E731  (the card is free: compared there)
        diffs = {k: (on_dev(a[k]).float() - on_dev(b[k]).float()).abs().max().item() for k in a
                 if k.startswith("lora/")}
        scale = max(on_dev(a[k]).float().abs().max().item() for k in diffs)
        resume = {"max_abs_diff": max(diffs.values()), "adapter_max_abs": scale,
                  "bitwise_equal": all(torch.equal(on_dev(a[k]), on_dev(b[k])) for k in a),
                  "tol": RESUME_REL_TOL * scale}
        del a, b
        if not resume["max_abs_diff"] <= resume["tol"]:
            problems.append(f"resume {resume}")
        if first["losses"][2:] != second["losses"]:
            resume["loss_diff"] = [x - y for x, y in zip(first["losses"][2:], second["losses"])]
        if problems:
            raise AssertionError(f"train_cli: {problems}\n{first}\n{second}")
        line = {"phase": "train_cli", "snapshot_written_here": written, "first": first, "resumed": second,
                "files": files, "resume": resume, "encode_cache_files": len(list(cache.glob("*.npz")))}
    finally:
        for d in (out1, out2, cache, clips):
            shutil.rmtree(d, ignore_errors=True)
        remove_smoke_files()
    emit(line)
    return {**line, "launches": first["launches"] + second["launches"]}


def phase_train_full_2b(dev, pipe, backend="flash", micro_steps=4, height=480, width=720, num_frames=49):
    """Full fine-tuning (``make_full_train_step``) of the 2b DiT at its
    published width (at the phase's ``DEPTH_CUT``): fp32 master weights (a copy of the fp16 tree), bf16
    compute, adamw with clip 1.0, accumulation 2, EMA 0.999, ``micro_steps``
    micro-steps (2 optimizer steps at the default 4) on one seeded 49x480x720 clip with its
    sincos table.  Losses finite; the master weights and the EMA moved (the
    EMA only on the accumulation boundary); per micro-step bf16 B1 twice and
    B2 once per block.  Then the train state (params, optimizer state with
    its EMA, step) goes through ``loaders/train_state.py`` into ``build/``
    and back onto the host, every tensor equal bit for bit; its size and the
    save and load seconds.  The pipeline's fp16 tree is left as it was."""
    import torch

    from s2v_torch.loaders.train_state import load_train_state, save_train_state
    from s2v_torch.training.full import floating_leaves, make_full_train_step
    from s2v_torch.training.optim import OptimizerSpec

    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    cfg, L = pipe.transformer_cfg, pipe.transformer_cfg.num_layers
    batch = _lora_batch(pipe, height, width, num_frames)
    opt = OptimizerSpec(optimizer="adamw", learning_rate=1e-5, beta1=0.9, beta2=0.95, weight_decay=1e-4,
                        epsilon=1e-8, max_grad_norm=1.0, gradient_accumulation_steps=2)
    prepare, init, step = make_full_train_step(cfg, pipe.scheduler_cfg, opt, attention_backend=backend,
                                               compute_dtype=torch.bfloat16, ema_decay=0.999)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = prepare(pipe.transformer_params, dtype=torch.float32)
    state = init(params)
    sync()
    prepare_s = time.perf_counter() - t0
    probe = lambda tree: floating_leaves(tree)[-2].detach().clone()  # noqa: E731  (proj_out's weight)
    start, ema_start = probe(params), probe(state[1])
    gen = torch.Generator(device=dev).manual_seed(5)
    losses, step_s, launches, ema_moved = [], [], [], []
    for i in range(micro_steps):
        reset_counts()
        ema_before = probe(state[1])
        t0 = time.perf_counter()
        params, state, loss = step(params, state, batch, gen)
        sync()
        step_s.append(time.perf_counter() - t0)
        launches.append(read_counts())
        losses.append(loss.item())
        ema_moved.append(not torch.equal(probe(state[1]), ema_before))
    problems = []
    if not all(np.isfinite(losses)):
        problems.append(f"losses {losses}")
    if torch.equal(probe(params), start) or torch.equal(probe(state[1]), ema_start):
        problems.append("the master weights or the EMA did not move")
    if ema_moved != [i % 2 == 1 for i in range(micro_steps)]:
        problems.append(f"the EMA moved at micro-steps {ema_moved}, not on the accumulation boundary")
    for i, c in enumerate(launches):
        if dev.type == "cuda" and (not check_counts(c, backend, 2 * L, L)
                                   or c["flash_attention_by_dtype"] != {"bfloat16": 2 * L + c["reruns"]}):
            problems.append(f"micro-step {i} launches {c}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 if dev.type == "cuda" else None
    tree = {"params": params, "opt_state": state, "step": micro_steps // 2}
    nbytes = sum(t.numel() * t.element_size() for t in floating_leaves(tree))
    path = REPO / "build" / "smoke_full_state"
    free = shutil.disk_usage(REPO / "build").free
    if free < nbytes + 2 ** 30:
        raise RuntimeError(f"{nbytes} bytes needed under build/ for the train state, {free} free")
    try:
        t0 = time.perf_counter()
        save_train_state(tree, str(path))
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = load_train_state(str(path), tree, device="cpu")
        load_s = time.perf_counter() - t0
        pairs = list(zip(floating_leaves(back), floating_leaves(tree)))
        equal = all(torch.equal(a, b.detach().cpu()) for a, b in pairs) and back["step"] == tree["step"]
        if not equal or len(pairs) != len(floating_leaves(tree)):
            problems.append("the train state did not come back bit for bit")
        del back, pairs
    finally:
        shutil.rmtree(path, ignore_errors=True)
    if problems:
        raise AssertionError(f"train_full_2b: {problems}")
    line = {"phase": "train_full_2b", "backend": backend, "config": "cogvideox_2b", "compute_dtype": "bfloat16",
            "master_dtype": "float32", "ema_decay": 0.999, "gradient_accumulation_steps": 2,
            "micro_steps": micro_steps, "batch_shape": list(batch["video_latents"].shape), "losses": losses,
            "step_s": step_s, "prepare_s": prepare_s, "ema_moved": ema_moved, "launches": launches,
            "max_memory_allocated_gb": peak_gb,
            "params": sum(t.numel() for t in floating_leaves(params)),
            "train_state": {"gb": nbytes / 1e9, "save_s": save_s, "load_s": load_s, "bitwise_equal": True}}
    emit(line)
    del params, state, tree
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return line


def _tail(path: Path, n: int = 40) -> str:
    return "\n".join(path.read_text(errors="replace").splitlines()[-n:]) if path.exists() else ""


def phase_serve(dev, pipe, backend="flash", height=480, width=720, num_frames=49):
    """The serving daemon as users run it: ``python3 -m s2v_torch.serve`` in
    a subprocess on the snapshot and the LoRA (merged) that ``pretrained``
    wrote, on the card, then over its socket: ``ping``; ``warmup`` without
    an image; a 2-step ``generate`` to an mp4; the same with ``use_dpm``,
    ``segment_steps`` 1 and cfg-skip; ``load_lora`` in runtime mode and a
    ``generate``; ``stats``; ``shutdown``.  Every response must say
    ``"status": "ok"`` and the daemon must exit 0.  The daemon's start
    seconds, each request's seconds, the swap seconds and the latencies
    ``stats`` reports.  Run without ``pretrained``, it writes them itself
    from ``pipe``; either way it leaves ``pipe`` without weights."""
    from s2v_torch.serving.client import request

    build = REPO / "build"
    snap, lora_dir, out_dir = build / "smoke_snapshot", build / "smoke_lora", build / "smoke_serve"
    written = None
    if not (snap.is_dir() and lora_dir.is_dir()):
        written = write_smoke_snapshot(pipe)
    release_pipe(pipe, dev)  # the daemon needs the card
    sock, ready, log = build / "smoke_serve.sock", build / "smoke_serve.ready", build / "smoke_serve.log"
    for path in (sock, ready):
        path.unlink(missing_ok=True)
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    png = out_dir / "ref.png"
    write_png(png, (np.random.RandomState(5).rand(height, width, 3) * 255).astype(np.uint8))
    cmd = [sys.executable, "-m", "s2v_torch.serve", "--pretrained_model_name_or_path", str(snap),
           "--checkpoint_path", str(lora_dir), "--socket", str(sock), "--ready_file", str(ready),
           "--device", dev.type]
    geo = dict(height=height, width=width, num_frames=num_frames, num_inference_steps=2)
    gen = {"op": "generate", "prompt": "<cls> a pig walking in the park", "ref_img_path": str(png), "seed": 7, **geo}
    requests = [
        ("ping", {"op": "ping"}),
        ("warmup", {"op": "warmup", **geo}),
        ("generate", {**gen, "output_path": str(out_dir / "merged.mp4")}),
        ("generate_options", {**gen, "output_path": str(out_dir / "options.mp4"), "use_dpm": True,
                              "segment_steps": 1, "use_dynamic_cfg": True, "cfg_skip_threshold": 0.02}),
        ("load_lora_runtime", {"op": "load_lora", "checkpoint_path": str(lora_dir), "lora_mode": "runtime"}),
        ("generate_runtime_lora", {**gen, "output_path": str(out_dir / "runtime.mp4")}),
        ("stats", {"op": "stats"}),
        ("shutdown", {"op": "shutdown"}),
    ]
    t_phase = time.perf_counter()
    with open(log, "w") as logf:
        proc = subprocess.Popen(cmd, cwd=str(REPO), env=dict(os.environ, PYTHONPATH=str(REPO)), stdout=logf,
                                stderr=subprocess.STDOUT)
    answers = {}
    try:
        while not ready.exists():
            if proc.poll() is not None or time.perf_counter() - t_phase > 600:
                raise AssertionError(f"serve: the daemon did not start (exit {proc.poll()}):\n{_tail(log)}")
            time.sleep(0.2)
        start_s = time.perf_counter() - t_phase
        for name, req in requests:
            t0 = time.perf_counter()
            resp = request(str(sock), req, timeout=900)
            seconds = time.perf_counter() - t0
            if resp.get("status") != "ok":
                raise AssertionError(f"serve: {name} answered {resp}\n{_tail(log)}")
            resp.pop("traceback", None)
            answers[name] = {"client_s": seconds, **resp}
            if "outputs" in resp:
                clip = Path(resp["outputs"][0])
                if resp["shape"] != [1, num_frames, height, width, 3] or not clip.is_file() or not clip.stat().st_size:
                    raise AssertionError(f"serve: {name} wrote {resp}")
                answers[name]["clip_bytes"] = clip.stat().st_size
        rc = proc.wait(timeout=120)
        if rc != 0:
            raise AssertionError(f"serve: the daemon exited {rc}:\n{_tail(log)}")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        for path in (sock, ready):
            path.unlink(missing_ok=True)
    line = {"phase": "serve", "snapshot_written_here": written, "start_s": start_s, "requests": answers,
            "swap_s": answers["load_lora_runtime"]["seconds"],
            "generate_latency_s": answers["stats"]["generate_latency_s"],
            "seconds": time.perf_counter() - t_phase, "log_tail": _tail(log, 6).splitlines()}
    emit(line)
    return line


# ---------------------------------------------------------------------------
# the data and model dims (one card: every dim a one-rank NCCL group)
# ---------------------------------------------------------------------------

# the full-width state of full fine-tuning a block takes on the card: fp32
# master, gradient, Adam's two moments and the EMA, and the block's bf16
# gather: 22 bytes a parameter; the activations of a remat step at 49 frames
# and the resident pipeline's working memory are kept free beside it
FSDP_BYTES_PER_PARAM = 22
FSDP_ACTIVATION_RESERVE = 16e9
MESH_SPEC = "dp1,sp1,tp1"


def phase_e2e_mesh(dev, pipe, backend="sp_allgather", name="e2e_mesh"):
    """``generate`` as ``e2e_sp_allgather`` on the one-rank mesh
    ``dp1,sp1,tp1`` with T5 on the mesh: ``set_mesh`` slices the DiT and
    T5 over the model dim (the sharded code at size 1), the CFG batch's rows
    go through the data dim's split and gather, the video frames through
    the seq dim's; 84 B1.  Its clip and latents are held against
    ``e2e_sp_allgather``'s after the run (``mesh_vs_single``).  The mesh is
    detached after, which gathers the params back whole."""
    import torch

    sp_mesh()
    pipe.t5_on_mesh = True
    t0 = time.perf_counter()
    pipe.set_mesh(MESH_SPEC)
    torch.cuda.synchronize()
    shard_s = time.perf_counter() - t0
    try:
        sliced = sum(int(p.model_dim is not None) for blk in pipe._tp_specs["blocks"] for grp in blk.values()
                     for leaf in grp.values() for p in leaf.values())
        return phase_e2e(dev, pipe, backend, name=name,
                         extra={"mesh": MESH_SPEC, "set_mesh_s": shard_s, "t5_on_mesh": True,
                                "model_sliced_leaves": sliced})
    finally:
        pipe.set_mesh(None)
        pipe.t5_on_mesh = False


def phase_e2e_mesh_int8(dev, pipe, backend="flash_int8"):
    """``e2e_int8``'s run (the int8 DiT, B3, at the cut depth) on the
    ``dp1,sp1,tp1`` mesh: the int8 tree sliced over the model dim, its
    row-parallel linears summing their int32 products over it; held against
    ``e2e_int8``'s after the run."""
    bf16_params = pipe.transformer_params
    params, _ = _quantized(pipe)
    pipe.transformer_params = params
    try:
        return phase_e2e_mesh(dev, pipe, backend, name="e2e_mesh_int8")
    finally:
        pipe.transformer_params = bf16_params


def mesh_vs_single(mesh, single, what) -> dict:
    """A mesh phase's clip and 1-step latents against the one-card phase's:
    bit for bit, or else within B1's limits with the reason; raises otherwise."""
    import torch

    line = {"phase": f"{what}_vs_single"}
    for key in ("video", "latents"):
        a, b = torch.as_tensor(np.asarray(mesh[key])), torch.as_tensor(np.asarray(single[key]))
        same = bool(torch.equal(a, b))
        line[key] = {"bitwise_equal": same}
        if not same:
            line[key].update(_agreement(a, b, f"{what} {key} against the one-card run's"),
                             why="the one-rank collectives hand every matmul the same operands in other buffers")
    return line


def _loss_and_grads(params, cfg, spec, lora, batch, alphas, timesteps, noise, backend, gather=None):
    """The LoRA loss and its adapters' gradients, counted and timed."""
    import torch

    from s2v_torch.training.lora import lora_leaves, lora_loss_fn

    leaves = lora_leaves(lora)
    for t in leaves:
        t.requires_grad_(True)
    reset_counts()
    t0 = time.perf_counter()
    try:
        loss = lora_loss_fn(lora, params, cfg, spec, batch, alphas, None, backend, True, timesteps=timesteps,
                            noise=noise, param_gather=gather)
        grads = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
    finally:
        for t in leaves:
            t.requires_grad_(False)
    return {"loss": loss.item(), "grads": [g.float() for g in grads], "counts": read_counts(),
            "seconds": time.perf_counter() - t0}


def phase_train_lora_mesh(dev, pipe, backend="flash", height=480, width=720, num_frames=49):
    """At the cut depth, the ``train_sp_backends`` clip and draws: the LoRA
    loss and adapter gradients with ``flash`` on one card, then on the
    one-rank ``dp1,tp1`` mesh (the base sliced over model; the batch split
    and gathered over data; the adapters' gradients summed over both), then
    with the base sharded over the one-rank data dim as ``--fsdp_base``
    shards it (``fsdp_param_specs`` at size 1, through the library: the
    CLI keeps JAX's refusal of a data dim below 2), each block gathered
    before it runs.  Each must equal the one-card loss and gradients bit
    for bit, or else lie within B2's limits with the reason; B1 twice and
    B2 once a block each."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from s2v_torch.config import SchedulerConfig
    from s2v_torch.parallel import default_logical_map, mesh_context
    from s2v_torch.parallel.context import data_parallel
    from s2v_torch.parallel.sharding import ParamGather, fsdp_param_specs, shard_params, transformer_param_specs_like
    from s2v_torch.schedulers.ddim import compute_alphas_cumprod
    from s2v_torch.training.lora import LoRASpec, init_lora_params

    t_phase = time.perf_counter()
    sp_mesh()
    params, cfg = pipe.transformer_params, pipe.transformer_cfg
    L = cfg.num_layers
    batch = _lora_batch(pipe, height, width, num_frames)
    spec = LoRASpec(rank=128, alpha=64.0)
    lora = init_lora_params(torch.Generator(device=dev).manual_seed(1), params, spec)
    for ab in lora.values():  # nonzero b, so that every a gets a gradient
        ab["b"].normal_(0.0, 1e-3, generator=torch.Generator(device=dev).manual_seed(2))
    alphas = torch.as_tensor(compute_alphas_cumprod(SchedulerConfig()), device=dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    timesteps = torch.randint(0, alphas.shape[0], (1,), generator=gen, device=dev)
    noise = torch.randn(batch["video_latents"].shape, generator=gen, device=dev)
    args = (cfg, spec, lora, batch, alphas, timesteps, noise, backend)
    runs = {"one_card": _loss_and_grads(params, *args)}
    mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
    with mesh_context(mesh, default_logical_map(mesh)):
        sliced = shard_params(params, mesh, transformer_param_specs_like(params))
        runs["dp1_tp1"] = _loss_and_grads(sliced, *args)
        del sliced
    data = init_device_mesh("cuda", (1,), mesh_dim_names=("data",))
    base_specs = fsdp_param_specs(params, 1)
    with mesh_context(data, default_logical_map(data)):
        shards = shard_params(params, data, base_specs)
        runs["fsdp_base_dp1"] = _loss_and_grads(shards, *args, gather=ParamGather(base_specs, data_parallel()))
        del shards
    names = [f"{n}.{k}" for n in sorted(lora) for k in ("a", "b")]
    ref = runs["one_card"]
    line = {"phase": "train_lora_mesh", "depth": L, "loss_one_card": ref["loss"], "runs": {}}
    for name, r in runs.items():
        if not check_counts(r["counts"], backend, 2 * L, L):
            raise AssertionError(f"train_lora_mesh: {name} launches {r['counts']}")
        if name == "one_card":
            continue
        same = [torch.equal(g, w) for g, w in zip(r["grads"], ref["grads"])]
        entry = {"loss": r["loss"], "loss_equal": r["loss"] == ref["loss"], "grads_bitwise_equal": all(same),
                 "launches": r["counts"], "loss_and_grad_s": r["seconds"]}
        if not all(same) or r["loss"] != ref["loss"]:
            grads = {n: _agreement(g, w, f"{name} grad {n}") for n, g, w in zip(names, r["grads"], ref["grads"])}
            entry.update(worst_grad=max(grads.values(), key=lambda s: s["rel_l2"]),
                         why="the one-rank collectives hand every matmul the same operands in other buffers")
            if abs(r["loss"] - ref["loss"]) > 1e-3 * abs(ref["loss"]):
                raise AssertionError(f"train_lora_mesh: {name} loss {r['loss']} against {ref['loss']}")
        line["runs"][name] = entry
    line["loss_and_grad_s_one_card"] = ref["seconds"]
    line["seconds"] = time.perf_counter() - t_phase
    emit(line)
    return {"launches": [r["counts"] for r in runs.values()]}


def fsdp_footprints() -> dict:
    """Per-rank bytes of full fine-tuning's state of the whole 42-block 5b
    DiT under FSDP at data = 4 and 8, computed from the placements of a
    ``meta`` tree (no memory): the fp32 master params, and the master plus
    gradient, Adam's two moments and the EMA."""
    import torch

    from s2v_torch import TransformerConfig
    from s2v_torch.models.transformer import init_transformer_params_random
    from s2v_torch.parallel.sharding import fsdp_param_specs, per_rank_bytes

    tree = init_transformer_params_random(TransformerConfig(dtype=torch.float32), device="meta")
    out = {"computed": "from the placements of a meta tree, not measured"}
    for n in (1, 4, 8):
        master = per_rank_bytes(tree, fsdp_param_specs(tree, n), {"data": n})
        out[f"data{n}"] = {"master_gb": master / 1e9, "master_grad_adam_ema_gb": 5 * master / 1e9}
    return out


def phase_train_full_5b_fsdp(dev, pipe, backend="flash", micro_steps=2, height=480, width=720, num_frames=49):
    """Full fine-tuning of the 5b DiT at its width under FSDP on the
    one-rank data dim, at the deepest cut (at most ``FSDP_DEPTH``, the
    phase's ``DEPTH_CUT``) whose state fits beside the
    resident pipeline (``FSDP_BYTES_PER_PARAM`` a parameter,
    ``FSDP_ACTIVATION_RESERVE`` kept free): bf16 compute, adamw with clip
    1.0, EMA 0.999, ``micro_steps`` micro-steps on the ``train`` clip with
    seeded draws.  First without a mesh (its losses, params and EMA kept on
    the host), then ``make_full_train_step(mesh=dp1)``: the shards cast and
    placed by ``prepare``, each block gathered in bf16 before it runs and
    again in the remat recompute, the gradients back to the shards, the
    clip norm summed over the data dim.  Losses, params and EMA equal bit
    for bit (or within B2's limits, with the reason); peak memory and the
    seconds of a micro-step; the sharded train state (one file for the
    rank, ``tree.json`` with the mesh and the placements) saved and read
    back bit for bit.  Also the per-rank bytes of the whole 42-block state
    at data = 4 and 8, computed from the placements."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from s2v_torch.loaders.train_state import load_train_state, save_train_state
    from s2v_torch.training.full import floating_leaves, make_full_train_step, state_placements
    from s2v_torch.training.optim import OptimizerSpec

    t_phase = time.perf_counter()
    sp_mesh()
    torch.cuda.empty_cache()
    block_params = sum(t.numel() for t in _tensors(pipe.transformer_params["blocks"][0]))
    free = torch.cuda.mem_get_info()[0]
    depth = int(min(pipe.transformer_cfg.num_layers,
                    (free - FSDP_ACTIVATION_RESERVE) // (FSDP_BYTES_PER_PARAM * block_params)))
    if depth < 1:
        raise AssertionError(f"train_full_5b_fsdp: {free / 1e9:.1f} GB free holds no block's state")
    opt = OptimizerSpec(optimizer="adamw", learning_rate=1e-5, beta1=0.9, beta2=0.95, weight_decay=1e-4,
                        epsilon=1e-8, max_grad_norm=1.0)
    mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("data",))
    runs = {}
    with cut_depth(pipe, depth):
        cfg, L = pipe.transformer_cfg, depth
        batch = _lora_batch(pipe, height, width, num_frames)
        for name, m in (("one_card", None), ("fsdp_dp1", mesh)):
            prepare, init, step = make_full_train_step(cfg, pipe.scheduler_cfg, opt, attention_backend=backend,
                                                       compute_dtype=torch.bfloat16, ema_decay=0.999, mesh=m)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            params = prepare(pipe.transformer_params, dtype=torch.float32)
            state = init(params)
            torch.cuda.synchronize()
            prepare_s = time.perf_counter() - t0
            gen = torch.Generator(device=dev).manual_seed(5)
            losses, step_s, launches = [], [], []
            for _ in range(micro_steps):
                reset_counts()
                t0 = time.perf_counter()
                params, state, loss = step(params, state, batch, gen)
                torch.cuda.synchronize()
                step_s.append(time.perf_counter() - t0)
                launches.append(read_counts())
                losses.append(loss.item())
            r = {"losses": losses, "step_s": step_s, "prepare_s": prepare_s, "launches": launches,
                 "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9}
            if m is None:
                r["host"] = [t.detach().cpu() for t in floating_leaves(params) + floating_leaves(state[1])]
            else:
                r["specs"], r["params"], r["state"] = prepare.specs, params, state
            runs[name] = r
            del params, state
    one, fsdp = runs["one_card"], runs["fsdp_dp1"]
    problems = []
    for name, r in runs.items():
        for i, c in enumerate(r["launches"]):
            if not check_counts(c, backend, 2 * L, L):
                problems.append(f"{name} micro-step {i} launches {c}")
        if not all(np.isfinite(r["losses"])):
            problems.append(f"{name} losses {r['losses']}")
    sharded = floating_leaves(fsdp["params"]) + floating_leaves(fsdp["state"][1])
    same = [torch.equal(a.cpu(), b) for a, b in zip(sharded, one["host"])]
    compare = {"losses_equal": fsdp["losses"] == one["losses"], "params_and_ema_bitwise_equal": all(same)}
    if not all(same) or not compare["losses_equal"]:
        worst = max((_agreement(a.cpu().float(), b.float(), "fsdp leaf") for a, b in zip(sharded, one["host"])),
                    key=lambda s: s["rel_l2"])
        compare.update(worst_leaf=worst, why="the one-rank gathers and reductions copy; a difference is the "
                                             "allocator handing a matmul another buffer")
    del one["host"], sharded
    path = REPO / "build" / "smoke_fsdp_state"
    tree = {"params": fsdp["params"], "opt_state": fsdp["state"], "step": micro_steps}
    nbytes = sum(t.numel() * t.element_size() for t in floating_leaves(tree))
    if shutil.disk_usage(REPO / "build").free < nbytes + 2 ** 30:
        raise RuntimeError(f"{nbytes} bytes needed under build/ for the sharded train state")
    try:
        t0 = time.perf_counter()
        save_train_state(tree, str(path), mesh=mesh, placements=state_placements(fsdp["specs"], True))
        save_s = time.perf_counter() - t0
        files = sorted(p.name for p in path.iterdir())
        t0 = time.perf_counter()
        back = load_train_state(str(path), tree, device="cpu", mesh=mesh)
        load_s = time.perf_counter() - t0
        equal = all(torch.equal(a, b.detach().cpu()) for a, b in zip(floating_leaves(back), floating_leaves(tree)))
        if not equal or files != ["tensors.rank0-of-1.safetensors", "tree.json"]:
            problems.append(f"the sharded train state did not come back bit for bit ({files})")
        del back
    finally:
        shutil.rmtree(path, ignore_errors=True)
    if problems:
        raise AssertionError(f"train_full_5b_fsdp: {problems}; {compare}")
    line = {"phase": "train_full_5b_fsdp", "backend": backend, "mesh": "dp1", "depth": depth,
            "of": pipe.transformer_cfg.num_layers, "free_gb_before": free / 1e9,
            "block_params": block_params, "micro_steps": micro_steps, "compute_dtype": "bfloat16",
            "one_card": {k: v for k, v in one.items() if k not in ("launches",)},
            "fsdp": {k: v for k, v in fsdp.items() if k not in ("specs", "params", "state", "launches")},
            "launches_fsdp": fsdp["launches"], "compare": compare,
            "train_state": {"gb": nbytes / 1e9, "save_s": save_s, "load_s": load_s, "files": files,
                            "bitwise_equal": True},
            "per_rank_state_42_blocks": fsdp_footprints(), "seconds": time.perf_counter() - t_phase}
    emit(line)
    del fsdp, tree
    torch.cuda.empty_cache()
    return {"launches": one["launches"] + line["launches_fsdp"], "depth": depth}


def phase_train_cli_mesh(dev, pipe, backend="sp_windowed", frames=9):
    """The trainer CLI across the three dims on one card:
    ``python3 -m torch.distributed.run --standalone --nproc_per_node 1 -m
    s2v_torch.train --mesh dp1,sp1,tp1 --attention_backend sp_windowed``
    (through the ``train_cli`` wrapper, which counts launches) on the
    ``pretrained`` snapshot (written here from ``pipe`` when that phase did
    not run) over two seeded ``frames``-frame 480x720 clips: LoRA rank 128,
    two micro-steps with a sharded train state after each (one file for
    the rank); B6 twice, B7 once, and B1/B2 for the global queries, a
    block per step.  A second run resumes from ``train_state_1`` and must
    end with the first run's adapters and optimizer state, bit for bit."""
    import torch

    from s2v_torch.loaders.safetensors_io import load_safetensors

    build = REPO / "build"
    snap = build / "smoke_snapshot"
    written = write_smoke_snapshot(pipe) if not snap.is_dir() else None
    L = 42
    release_pipe(pipe, dev)
    clips = write_smoke_clips(num_frames=frames)
    out1, out2 = build / "smoke_train_mesh", build / "smoke_train_mesh_resumed"
    wrapper = build / "smoke_train_cli_wrapper.py"
    wrapper.write_text(_TRAIN_CLI_WRAPPER)
    common = [str(wrapper), "--pretrained_model_name_or_path", str(snap), "--dataset_dir", str(clips),
              "--rank", "128", "--lora_alpha", "64", "--max_grad_norm", "1.0", "--checkpointing_steps", "1",
              "--max_train_steps", "2", "--height", "480", "--width", "720", "--max_num_frames", str(frames),
              "--device", dev.type, "--mesh", MESH_SPEC, "--attention_backend", backend]
    runs = {}
    try:
        for name, extra, out in (("first", [], out1),
                                 ("resumed", ["--resume_from_checkpoint", str(out1 / "train_state_1")], out2)):
            shutil.rmtree(out, ignore_errors=True)
            log = build / f"smoke_train_mesh_{name}.log"
            t0 = time.perf_counter()
            proc = _torchrun([*common, *extra, "--output_dir", str(out)], log)
            rc = proc.wait(timeout=600)
            lines = [ln for ln in log.read_text().splitlines() if ln.startswith('{"train_cli"')]
            if rc != 0 or not lines:
                raise AssertionError(f"train_cli_mesh: {name} exited {rc}\n{_tail(log)}")
            runs[name] = {**json.loads(lines[-1])["train_cli"], "wall_s": time.perf_counter() - t0}
        files = _files(out1)
        want = {"pytorch_lora_weights_transformer.safetensors", "train_state_1/tensors.rank0-of-1.safetensors",
                "train_state_1/tree.json", "train_state_2/tensors.rank0-of-1.safetensors", "train_state_2/tree.json"}
        problems = []
        if set(files) != want:
            problems.append(f"files {files}")
        for name, r in runs.items():
            if not all(np.isfinite(r["losses"])):
                problems.append(f"{name} losses {r['losses']}")
            for c in r["launches"]:
                if not check_counts(c, backend, 2 * L, L):
                    problems.append(f"{name} launches {c}")
        a = load_safetensors(str(out1 / "train_state_2" / "tensors.rank0-of-1.safetensors"))
        b = load_safetensors(str(out2 / "train_state_2" / "tensors.rank0-of-1.safetensors"))
        resume = {"bitwise_equal": sorted(a) == sorted(b) and all(torch.equal(a[k], b[k]) for k in a),
                  "tensors": len(a)}
        if not resume["bitwise_equal"]:
            resume["max_abs_diff"] = max((a[k].float() - b[k].float()).abs().max().item() for k in a if k in b)
            problems.append(f"the resumed run's state is not the first run's: {resume}")
        mesh_line = json.loads((out1 / "train_state_2" / "tree.json").read_text())["mesh"]
        if problems:
            raise AssertionError(f"train_cli_mesh: {problems}\n{runs}")
        line = {"phase": "train_cli_mesh", "mesh": MESH_SPEC, "backend": backend, "frames": frames,
                "snapshot_written_here": written, "first": runs["first"], "resumed": runs["resumed"],
                "files": files, "resume": resume, "state_mesh": mesh_line}
    finally:
        for d in (out1, out2, clips):
            shutil.rmtree(d, ignore_errors=True)
    emit(line)
    return {"launches": runs["first"]["launches"] + runs["resumed"]["launches"]}


# ---------------------------------------------------------------------------
# fp32: kernels B1, B2 and B4-B7 on fp32 inputs (csrc/attention_f32.cu,
# csrc/attention_f32_bwd.cu: 3xTF32 on wgmma), the route of --dtype float32
# ---------------------------------------------------------------------------

# the H100 SXM's dense TF32 tensor-core peak (NVIDIA data sheet); 3xTF32 runs
# three TF32 products for each product of the bound, so 3x the bound is the
# design's floor (the "3-pass floor")
PEAK_TF32_FLOPS = 495e12
TF32_PASSES = 3
# fp32 kernels against their plain versions (fp32 with TF32 matmuls off) and
# against the emulations of their 3xTF32 schedules: 3xTF32 keeps products to
# about 2^-21 relative and the sums are fp32 in another order, so the
# forward's outputs agree to ~1e-6 relative (the emulation on the CPU:
# ~1e-6 max, ~5e-7 L2), the backward's, which sum dS over every key or query,
# to a few 1e-6.  One TF32 pass (10 mantissa bits, 2^-11 relative per
# operand) gives ~5e-4 max and ~3e-4 L2 on the same outputs: every limit here
# lies below that.
FP32_FWD_MAX_REL, FP32_FWD_L2 = 2.0 ** -14, 2e-5
FP32_BWD_MAX_REL, FP32_BWD_L2 = 2.0 ** -12, 1e-4
# lse in fp32: ~1e-6 of values near 10
FP32_LSE_TOL = 1e-4
# the small cases of the fp32 banded phases: ragged frames and globals,
# clamped windows, w = 0, a small clip, a window wider than the clip, the
# main shape's remainders
BANDED_SMALL_FP32 = [(2, 3, 24, 20, 5, 1), (1, 2, 24, 20, 3, 2), (1, 2, 24, 20, 4, 0), (1, 2, 1, 8, 2, 0),
                     (1, 2, 50, 40, 5, 9), (1, 2, 168, 198, 5, 2), (1, 2, 129, 16, 7, 3)]
# heads of the main shape that the 3xTF32 emulations run on (every head is an
# independent problem; the emulation of all 48 would take minutes)
FP32_EMULATED_HEADS = 2


def _agreement_f32(o, o_ref, what, bwd=False, limits=None):
    """An fp32 output against a reference with the fp32 kernel limits above
    (or ``limits``, (max_rel, rel_l2)); an all-zero reference (a shard's
    dk/dv partial that no query reaches) needs an all-zero output."""
    max_rel, l2 = limits or ((FP32_BWD_MAX_REL, FP32_BWD_L2) if bwd else (FP32_FWD_MAX_REL, FP32_FWD_L2))
    o_ref = o_ref.float()
    diff = o.float() - o_ref
    ref_max = o_ref.abs().max().item()
    if ref_max == 0:
        err = o.float().abs().max().item()
        if err != 0:
            raise AssertionError(f"{what}: reference is zero, kernel max |x| {err}")
        return {"max_abs_err": 0.0, "max_abs_tol": 0.0, "rel_l2": 0.0, "rel_l2_tol": l2, "ref_max": 0.0}
    stats = {"max_abs_err": diff.abs().max().item(), "max_abs_tol": max_rel * ref_max,
             "rel_l2": (diff.norm() / o_ref.norm()).item(), "rel_l2_tol": l2, "ref_max": ref_max}
    if not (stats["max_abs_err"] <= stats["max_abs_tol"] and stats["rel_l2"] < l2):
        raise AssertionError(f"{what}: {stats}")
    return stats


def _lse_f32(lse, lse_ref, what):
    err = (lse - lse_ref).abs().max().item() if lse.numel() else 0.0
    if not err < FP32_LSE_TOL:
        raise AssertionError(f"{what}: lse max_abs_err {err} (tol {FP32_LSE_TOL})")
    return err


def _f32_bound(flops, nbytes):
    """(bound_ms, bound_by, tf32_one_pass_ms): the bound is the larger of the
    operations at fp32 accuracy on the tensor cores (three TF32 passes, the
    3-pass floor; fp32 without them runs at 67 TFLOP/s, slower) and the
    bytes over the memory rate; one TF32 pass, which keeps only about three
    digits and so is not the same work, is given beside it."""
    t_ops, t_bytes = flops / PEAK_TF32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return (max(TF32_PASSES * t_ops, t_bytes) * 1e3, "operations" if TF32_PASSES * t_ops >= t_bytes else "bytes",
            t_ops * 1e3)


def _ms3(fn):
    """CUDA events over 3 launches after one warm-up (the fp32 kernels are slow)."""
    fn()
    return cuda_ms(fn, 3)


def _worst(cases, key="max_abs_err", tol="max_abs_tol"):
    shares = [c[key] / c[tol] for c in cases if c.get(tol)]
    return max(shares) if shares else 0.0


def _qkv32(b, sq, skv, h, seed, dev, layer_norm=False):
    import torch
    import torch.nn.functional as F

    q, k, v = _qkv(b, sq, skv, h, seed, dev, torch.float32)
    if layer_norm:
        q, k = F.layer_norm(q, (64,)), F.layer_norm(k, (64,))
    return q, k, v


def phase_kernel_fp32(dev):
    """Kernel B1 in fp32 against its plain version and the emulation of its
    3xTF32 schedule: small ragged shapes in every softmax mode (a key pad
    mask, Skv below one tile), a bounded call that must re-run online, then
    the main shape B=2, S=19,126, H=48 (the emulation on its first heads),
    timed over 3 launches beside its bound, its 3-pass floor, the plain
    version and fp32 SDPA (a yardstick only)."""
    import torch
    import torch.nn.functional as F

    from s2v_torch.kernels import attention_f32 as af
    from s2v_torch.kernels import native
    from s2v_torch.kernels.flash_attention import flash_attention, flash_attention_reference

    def compare(q, k, v, mode, mask=None, emulate=True):
        o, lse = flash_attention(q, k, v, return_lse=True, key_pad_mask=mask, softmax_mode=mode)
        o_ref, lse_ref = flash_attention_reference(q, k, v, return_lse=True, key_pad_mask=mask, softmax_mode=mode)
        what = f"fp32 flash_attention[{mode}] {tuple(q.shape)}x{tuple(k.shape)}"
        stats = {**_agreement_f32(o, o_ref, what), "lse_err": _lse_f32(lse, lse_ref, what)}
        if emulate:
            o_e, lse_e = af.flash_attention_f32_blocked(q, k, v, return_lse=True, key_pad_mask=mask, softmax_mode=mode)
            st = _agreement_f32(o, o_e, what + " against the 3xTF32 emulation")
            stats.update(schedule_max_abs_err=st["max_abs_err"], schedule_rel_l2=st["rel_l2"],
                         schedule_lse_err=_lse_f32(lse, lse_e, what + " against the emulation"))
        return stats

    small = []
    for mode in MODES:
        for (b, sq, skv, h, masked) in [(2, 200, 200, 3, False), (1, 77, 333, 2, True), (2, 1000, 129, 2, False),
                                        (1, 130, 40, 2, False), (1, 300, 1000, 2, True)]:
            q, k, v = _qkv32(b, sq, skv, h, sq + skv, dev)
            mask = None
            if masked:
                mask = torch.zeros(skv, dtype=torch.bool, device=dev)
                mask[5:40] = True
                mask[-3:] = True
            small.append({"mode": mode, "q": [b, sq, h, 64], "skv": skv, "masked": masked,
                          **compare(q, k, v, mode, mask)})
    q, k, v = _qkv32(1, 256, 256, 2, 5, dev)
    q[..., 32:] = 0
    k[..., :32] = 0
    q, k = q * 400, k * 400  # every bounded p underflows in fp32: the online re-run must run
    before = native.launches("flash_attention_rerun")
    rerun = {"q": [1, 256, 2, 64], **compare(q, k, v, "bounded")}
    if q.is_cuda and native.launches("flash_attention_rerun") == before:
        raise AssertionError("fp32 bounded re-run not taken")
    emit({"phase": "kernel_fp32_small", "cases": small, "rerun": rerun})

    b, s, h, d = MAIN_SHAPE
    q, k, v = _qkv32(b, s, s, h, 7, dev, layer_norm=True)
    main = {}
    for mode in ("online", MAIN_MODE):
        main[mode] = compare(q, k, v, mode, emulate=False)
        main[mode]["ms"] = _ms3(lambda: flash_attention(q, k, v, softmax_mode=mode))
    e = FP32_EMULATED_HEADS
    o_k = flash_attention(q, k, v, softmax_mode="online")[:, :, :e]
    o_e = af.flash_attention_f32_blocked(*(x[:, :, :e].contiguous() for x in (q, k, v)))
    emulated = _agreement_f32(o_k, o_e, f"fp32 flash_attention main shape, heads 0-{e - 1}, against the emulation")
    del o_k, o_e
    plain_ms = cuda_ms(lambda: flash_attention_reference(q, k, v, softmax_mode=MAIN_MODE), 1)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    library_ms = _ms3(lambda: F.scaled_dot_product_attention(qt, kt, vt))
    flops = 4 * b * h * s * s * d
    bound_ms, bound_by, one_pass_ms = _f32_bound(flops, 4 * b * s * h * d * 4 + b * h * s * 4)
    result = {"phase": "kernel_fp32_main", "shape": list(MAIN_SHAPE), "dtype": "float32", "modes": main,
              "emulated_heads": e, "schedule": emulated, "plain_ms": plain_ms, "library_ms": library_ms,
              "bound_ms": bound_ms, "bound_by": bound_by, "tf32_one_pass_ms": one_pass_ms,
              "tflops": flops / main[MAIN_MODE]["ms"] / 1e9, "smem_bytes": af.smem_bytes(),
              "small_worst_err_share": _worst(small)}
    emit(result)
    return result


def phase_kernel_bwd_fp32(dev):
    """Kernel B2 in fp32 against its plain version and the emulation of its
    3xTF32 schedule: small ragged shapes (Sq != Skv), then the training shape
    B=1 (the emulation on its first heads; two launches bit for bit), timed
    over 3 launches, split among its three kernels, beside its bound, its
    3-pass floor, the plain version and fp32 SDPA's backward."""
    import torch
    import torch.nn.functional as F

    from s2v_torch.kernels import attention_f32 as af
    from s2v_torch.kernels.flash_attention import flash_attention
    from s2v_torch.kernels.flash_attention_bwd import flash_attention_bwd, flash_attention_bwd_reference

    def inputs(b, sq, skv, h, seed, layer_norm=False):
        q, k, v = _qkv32(b, sq, skv, h, seed, dev, layer_norm)
        o, lse = flash_attention(q, k, v, return_lse=True, softmax_mode=MAIN_MODE)
        do = torch.randn(q.shape, device=dev, generator=torch.Generator(device=dev).manual_seed(seed + 1))
        return q, k, v, o, lse, do

    def compare(args, emulate=True):
        got = flash_attention_bwd(*args)
        what = f"fp32 flash_attention_bwd {tuple(args[0].shape)}x{tuple(args[1].shape)}"
        stats = {n: _agreement_f32(a, r, f"{what} {n}", bwd=True)
                 for n, a, r in zip(("dq", "dk", "dv"), got, flash_attention_bwd_reference(*args))}
        if emulate:
            for n, a, r in zip(("dq", "dk", "dv"), got, af.flash_attention_bwd_f32_blocked(*args)):
                stats[n]["schedule_max_abs_err"] = _agreement_f32(a, r, f"{what} {n} against the emulation",
                                                                  bwd=True)["max_abs_err"]
        return stats

    small = [{"q": [b, sq, h, 64], "skv": skv, **compare(inputs(b, sq, skv, h, sq + skv))}
             for (b, sq, skv, h) in [(2, 200, 200, 3), (1, 77, 333, 2), (2, 1000, 129, 2), (1, 130, 40, 2)]]
    emit({"phase": "kernel_bwd_fp32_small", "cases": small})

    b, s, h, d = TRAIN_SHAPE
    args = inputs(b, s, s, h, 11, layer_norm=True)
    stats = compare(args, emulate=False)
    e = FP32_EMULATED_HEADS
    got = [x[:, :, :e] for x in flash_attention_bwd(*args)]
    sliced = [x[:, :, :e].contiguous() for x in args[:4]] + [args[4][:, :e].contiguous(), args[5][:, :, :e].contiguous()]
    emulated = {n: _agreement_f32(a, r, f"fp32 flash_attention_bwd main shape {n} against the emulation", bwd=True)
                for n, a, r in zip(("dq", "dk", "dv"), got, af.flash_attention_bwd_f32_blocked(*sliced))}
    del got, sliced
    deterministic = _determinism(flash_attention_bwd, args, "fp32 flash_attention_bwd")
    ms = _ms3(lambda: flash_attention_bwd(*args))
    q, k, v, o, lse, do = args
    grads = [torch.empty_like(x) for x in (q, k, v)]
    ws, planes = af.bwd_workspace(q), af.bwd_planes(q, k)
    parts_ms = {}
    af.launch_bwd(q, k, v, o, do, lse, *grads, d ** -0.5, workspace=ws, planes=planes)
    for name, part in (("prepass", af.PART_PREPASS), ("dq", af.PART_DQ), ("dkv", af.PART_DKV)):
        parts_ms[name] = _ms3(lambda: af.launch_bwd(q, k, v, o, do, lse, *grads, d ** -0.5, workspace=ws,
                                                    planes=planes, parts=part))
    del grads, ws, planes
    plain_ms = cuda_ms(lambda: flash_attention_bwd_reference(*args), 1)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    out = F.scaled_dot_product_attention(qt, kt, vt)
    gt = do.transpose(1, 2)
    library_ms = _ms3(lambda: torch.autograd.grad(out, (qt, kt, vt), gt, retain_graph=True))
    del out, qt, kt, vt
    flops = 10 * b * h * s * s * d
    bound_ms, bound_by, one_pass_ms = _f32_bound(flops, 8 * b * s * h * d * 4 + b * h * s * 4)
    result = {"phase": "kernel_bwd_fp32_main", "shape": list(TRAIN_SHAPE), "dtype": "float32", "grads": stats,
              "schedule": emulated, "emulated_heads": e, "deterministic": deterministic, "ms": ms,
              "parts_ms": parts_ms, "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
              "bound_by": bound_by, "tf32_one_pass_ms": one_pass_ms, "tflops": flops / ms / 1e9,
              "small_worst_err_share": max(_worst(list(c[n] for c in small)) for n in ("dq", "dk", "dv"))}
    emit(result)
    return result


def _banded_f32_emulated(q, k, v, band):
    """B4's fp32 kernels emulated as the CUDA path runs them: the video rows
    on the banded schedule, the global rows through B1's online schedule."""
    import torch

    from s2v_torch.kernels import attention_f32 as af
    from s2v_torch.kernels.banded_attention import band_geometry

    geo = band_geometry(q.shape[1], *band)
    g = geo.global_len
    o_vid, lse_vid = af.banded_f32_blocked(q[:, g:], k, v, geo, return_lse=True)
    o_glob, lse_glob = af.flash_attention_f32_blocked(q[:, :g], k, v, return_lse=True)
    return torch.cat([o_glob, o_vid], dim=1), torch.cat([lse_glob, lse_vid], dim=-1)


def _banded_bwd_f32_emulated(q, k, v, o, lse, do, band):
    """B5's fp32 kernels emulated as the CUDA path runs them (the video
    queries' banded part plus the global queries' B2 part)."""
    import torch

    from s2v_torch.kernels import attention_f32 as af
    from s2v_torch.kernels.banded_attention import band_geometry

    geo = band_geometry(q.shape[1], *band)
    g = geo.global_len
    dq_v, dk_v, dv_v = af.banded_bwd_f32_blocked(q[:, g:], k, v, o[:, g:], lse[..., g:], do[:, g:], geo)
    dq_g, dk_g, dv_g = af.flash_attention_bwd_f32_blocked(q[:, :g], k, v, o[:, :g], lse[..., :g], do[:, :g])
    return torch.cat([dq_g, dq_v], dim=1), dk_v + dk_g, dv_v + dv_g


def phase_kernel_banded_fp32(dev):
    """Kernel B4 in fp32 (the global queries through B1 in fp32) against its
    plain version and the emulation of its schedule: small geometries, then
    the main band (B=2; the emulation on its first heads), timed over 3
    launches beside its bound, its 3-pass floor, the plain version and fp32
    masked SDPA over the video queries."""
    import torch

    from s2v_torch.kernels.banded_attention import (
        band_geometry,
        banded_flash_attention,
        banded_flash_attention_reference,
    )

    def compare(q, k, v, band, emulate=True):
        o, lse = banded_flash_attention(q, k, v, *band, return_lse=True)
        o_ref, lse_ref = banded_flash_attention_reference(q, k, v, *band, return_lse=True)
        what = f"fp32 banded_flash_attention {tuple(q.shape)} band {band}"
        stats = {**_agreement_f32(o, o_ref, what), "lse_err": _lse_f32(lse, lse_ref, what)}
        if emulate:
            o_e, lse_e = _banded_f32_emulated(q, k, v, band)
            stats["schedule_max_abs_err"] = _agreement_f32(o, o_e, what + " against the emulation")["max_abs_err"]
            stats["schedule_lse_err"] = _lse_f32(lse, lse_e, what + " against the emulation")
        return stats

    small = []
    for (b, h, g, tpf, f, w) in BANDED_SMALL_FP32:
        q, k, v = _qkv32(b, g + f * tpf, g + f * tpf, h, g + tpf + f, dev)
        small.append({"b": b, "h": h, "band": [g, tpf, f, w], **compare(q, k, v, (g, tpf, w))})
    emit({"phase": "kernel_banded_fp32_small", "cases": small})

    b, s, h, d = MAIN_SHAPE
    geo = band_geometry(s, *BAND)
    q, k, v = _qkv32(b, s, s, h, 7, dev, layer_norm=True)
    stats = compare(q, k, v, BAND, emulate=False)
    e = FP32_EMULATED_HEADS
    o_k = banded_flash_attention(q, k, v, *BAND)[:, :, :e]
    o_e, _ = _banded_f32_emulated(*(x[:, :, :e].contiguous() for x in (q, k, v)), BAND)
    emulated = _agreement_f32(o_k, o_e, "fp32 banded_flash_attention main band against the emulation")
    del o_k, o_e
    ms = _ms3(lambda: banded_flash_attention(q, k, v, *BAND))
    plain_ms = cuda_ms(lambda: banded_flash_attention_reference(q, k, v, *BAND), 1)
    rows = torch.arange(geo.global_len, s, device=dev)
    library_ms, library_shape, library_failed = _masked_sdpa_ms(q[:, geo.global_len:], k, v, rows, geo)
    pairs_vid, pairs_glob = geo.pairs()
    flops = 4 * b * h * d * (pairs_vid + pairs_glob)
    bound_ms, bound_by, one_pass_ms = _f32_bound(flops, 4 * b * s * h * d * 4 + b * h * s * 4)
    result = {"phase": "kernel_banded_fp32_main", "shape": list(MAIN_SHAPE), "band": list(BAND), "dtype": "float32",
              **stats, "schedule": emulated, "emulated_heads": e, "ms": ms, "plain_ms": plain_ms,
              "library_ms": library_ms, "library_shape": library_shape, "library_not_run": library_failed,
              "library_covers": "video queries (fp32 masked SDPA)", "bound_ms": bound_ms, "bound_by": bound_by,
              "tf32_one_pass_ms": one_pass_ms, "tflops": flops / ms / 1e9, "small_worst_err_share": _worst(small)}
    emit(result)
    return result


def phase_kernel_banded_bwd_fp32(dev):
    """Kernel B5 in fp32 (the global queries through B2 in fp32) against its
    plain version and the emulation of its schedule: small geometries, then
    the training band (B=1; the emulation on its first heads; two launches
    bit for bit), timed beside its bound, its 3-pass floor, the plain version
    and the backward of fp32 masked SDPA over the video queries."""
    import torch

    from s2v_torch.kernels.banded_attention import band_geometry, banded_flash_attention
    from s2v_torch.kernels.banded_attention_bwd import (
        banded_flash_attention_bwd,
        banded_flash_attention_bwd_reference,
    )

    def inputs(b, h, s, band, seed, layer_norm=False):
        q, k, v = _qkv32(b, s, s, h, seed, dev, layer_norm)
        o, lse = banded_flash_attention(q, k, v, *band, return_lse=True)
        do = torch.randn(q.shape, device=dev, generator=torch.Generator(device=dev).manual_seed(seed + 1))
        return q, k, v, o, lse, do

    def compare(args, band, emulate=True):
        got = banded_flash_attention_bwd(*args, *band)
        what = f"fp32 banded_flash_attention_bwd {tuple(args[0].shape)} band {band}"
        stats = {n: _agreement_f32(a, r, f"{what} {n}", bwd=True)
                 for n, a, r in zip(("dq", "dk", "dv"), got, banded_flash_attention_bwd_reference(*args, *band))}
        if emulate:
            for n, a, r in zip(("dq", "dk", "dv"), got, _banded_bwd_f32_emulated(*args, band)):
                stats[n]["schedule_max_abs_err"] = _agreement_f32(a, r, f"{what} {n} against the emulation",
                                                                  bwd=True)["max_abs_err"]
        return stats

    small = []
    for (b, h, g, tpf, f, w) in BANDED_SMALL_FP32:
        small.append({"b": b, "h": h, "band": [g, tpf, f, w],
                      **compare(inputs(b, h, g + f * tpf, (g, tpf, w), g + tpf + f), (g, tpf, w))})
    emit({"phase": "kernel_banded_bwd_fp32_small", "cases": small})

    b, s, h, d = TRAIN_SHAPE
    geo = band_geometry(s, *BAND)
    args = inputs(b, h, s, BAND, 11, layer_norm=True)
    stats = compare(args, BAND, emulate=False)
    e = FP32_EMULATED_HEADS
    got = [x[:, :, :e] for x in banded_flash_attention_bwd(*args, *BAND)]
    sliced = [x[:, :, :e].contiguous() for x in args[:4]] + [args[4][:, :e].contiguous(), args[5][:, :, :e].contiguous()]
    emulated = {n: _agreement_f32(a, r, f"fp32 banded_flash_attention_bwd main band {n} against the emulation",
                                  bwd=True)
                for n, a, r in zip(("dq", "dk", "dv"), got, _banded_bwd_f32_emulated(*sliced, BAND))}
    del got, sliced
    deterministic = _determinism(banded_flash_attention_bwd, (*args, *BAND), "fp32 banded_flash_attention_bwd")
    ms = _ms3(lambda: banded_flash_attention_bwd(*args, *BAND))
    plain_ms = cuda_ms(lambda: banded_flash_attention_bwd_reference(*args, *BAND), 1)
    rows = torch.arange(geo.global_len, s, device=dev)
    library_ms, library_shape, library_failed = _masked_sdpa_ms(args[0][:, geo.global_len:], args[1], args[2], rows,
                                                                geo, grad=args[5][:, geo.global_len:])
    pairs_vid, pairs_glob = geo.pairs()
    flops = 10 * b * h * d * (pairs_vid + pairs_glob)
    bound_ms, bound_by, one_pass_ms = _f32_bound(flops, 8 * b * s * h * d * 4 + b * h * s * 4)
    result = {"phase": "kernel_banded_bwd_fp32_main", "shape": list(TRAIN_SHAPE), "band": list(BAND),
              "dtype": "float32", "grads": stats, "schedule": emulated, "emulated_heads": e,
              "deterministic": deterministic, "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
              "library_shape": library_shape, "library_not_run": library_failed,
              "library_covers": "video queries (backward of fp32 masked SDPA)", "bound_ms": bound_ms,
              "bound_by": bound_by, "tf32_one_pass_ms": one_pass_ms, "tflops": flops / ms / 1e9,
              "small_worst_err_share": max(_worst(list(c[n] for c in small)) for n in ("dq", "dk", "dv"))}
    emit(result)
    return result


def _local_f32_shards(ring, n_frames):
    from s2v_torch.kernels.banded_attention import ring_shards

    _, f_loc = ring_shards(n_frames, ring)
    return [(r, r * f_loc, f_loc) for r in range(ring)]


def phase_kernel_banded_local_fp32(dev):
    """Kernel B6 in fp32 (one shard of video-query frames at a runtime frame
    offset) against its plain version and the emulation of its schedule: the
    small geometries at every offset of a 2- and a 4-rank ring (dummy
    frames, and rings past the frame count, included); then each shard of a
    4-rank ring over the main band (B=2), timed beside its bound, its 3-pass
    floor, the plain version and fp32 masked SDPA over the shard's
    queries."""
    import torch

    from s2v_torch.kernels import attention_f32 as af
    from s2v_torch.kernels.banded_attention import (
        band_geometry,
        banded_flash_attention_local,
        banded_flash_attention_local_reference,
    )

    def compare(q_loc, k, v, geo, off, emulate=True):
        band = (geo.global_len, geo.tokens_per_frame, geo.window)
        o, lse = banded_flash_attention_local(q_loc, k, v, *band, off, geo.n_frames, return_lse=True)
        o_ref, lse_ref = banded_flash_attention_local_reference(q_loc, k, v, *band, off, geo.n_frames,
                                                                return_lse=True)
        what = f"fp32 banded_flash_attention_local {tuple(q_loc.shape)} band {band} offset {off}"
        stats = {**_agreement_f32(o, o_ref, what), "lse_err": _lse_f32(lse, lse_ref, what)}
        if emulate:
            shard = geo.shard(off, q_loc.shape[1] // geo.tokens_per_frame)
            o_e, lse_e = af.banded_f32_blocked(q_loc, k, v, shard, return_lse=True)
            stats["schedule_max_abs_err"] = _agreement_f32(o, o_e, what + " against the emulation")["max_abs_err"]
            stats["schedule_lse_err"] = _lse_f32(lse, lse_e, what + " against the emulation")
        return stats

    small = []
    for (b, h, g, tpf, f, w) in BANDED_SMALL_FP32:
        geo = band_geometry(g + f * tpf, g, tpf, w)
        q, k, v = _qkv32(b, g + f * tpf, g + f * tpf, h, g + tpf + f + 3, dev)
        for ring in (2, 4):
            for r, off, f_loc in _local_f32_shards(ring, f):
                small.append({"band": [b, h, g, tpf, f, w], "ring": ring, "offset": off,
                              "dummy_frames": f_loc - geo.shard(off, f_loc).real_frames(),
                              **compare(_shard_rows(q, geo, f_loc, off), k, v, geo, off)})
    emit({"phase": "kernel_banded_local_fp32_small", "cases": small})

    b, s, h, d = MAIN_SHAPE
    geo = band_geometry(s, *BAND)
    g_len, tpf = geo.global_len, geo.tokens_per_frame
    q, k, v = _qkv32(b, s, s, h, 7, dev, layer_norm=True)
    shards = []
    for r, off, f_loc in _local_f32_shards(4, geo.n_frames):
        shard = geo.shard(off, f_loc)
        q_loc = _shard_rows(q, geo, f_loc, off)
        stats = compare(q_loc, k, v, geo, off, emulate=False)
        ms = _ms3(lambda: banded_flash_attention_local(q_loc, k, v, *BAND, off, geo.n_frames))
        plain_ms = cuda_ms(lambda: banded_flash_attention_local_reference(q_loc, k, v, *BAND, off, geo.n_frames), 1)
        rows = torch.arange(g_len + off * tpf, g_len + (off + f_loc) * tpf, device=dev)
        library_ms, library_shape, _ = _masked_sdpa_ms(q_loc, k, v, rows, geo)
        sq = q_loc.shape[1]
        flops = 4 * b * h * d * shard.shard_pairs()
        bound_ms, bound_by, one_pass_ms = _f32_bound(flops, (2 * sq + 2 * s) * b * h * d * 4)
        shards.append({"rank": r, "offset": off, "local_frames": f_loc,
                       "dummy_frames": f_loc - shard.real_frames(), **stats, "ms": ms, "plain_ms": plain_ms,
                       "library_ms": library_ms, "library_shape": library_shape, "bound_ms": bound_ms,
                       "bound_by": bound_by, "tf32_one_pass_ms": one_pass_ms, "tflops": flops / ms / 1e9})
    e = FP32_EMULATED_HEADS
    _, off, f_loc = _local_f32_shards(4, geo.n_frames)[0]
    q_loc = _shard_rows(q, geo, f_loc, off)[:, :, :e].contiguous()
    k_e, v_e = k[:, :, :e].contiguous(), v[:, :, :e].contiguous()
    emulated = _agreement_f32(banded_flash_attention_local(q_loc, k_e, v_e, *BAND, off, geo.n_frames),
                              af.banded_f32_blocked(q_loc, k_e, v_e, geo.shard(off, f_loc)),
                              "fp32 banded_flash_attention_local main band rank 0 against the emulation")
    result = {"phase": "kernel_banded_local_fp32_main", "shape": list(MAIN_SHAPE), "band": list(BAND),
              "dtype": "float32", "ring": 4, "shards": shards, "schedule_rank0": emulated, "emulated_heads": e,
              "small_worst_err_share": _worst(small)}
    emit(result)
    return result


def phase_kernel_banded_local_bwd_fp32(dev):
    """Kernel B7 in fp32 (the backward of B6 for one shard) against its plain
    version and the emulation of its schedule: the small geometries at every
    offset of a 2- and a 4-rank ring (rings past the frame count included),
    then each shard of a 4-rank ring over the training band (B=1), timed
    beside its bound, its 3-pass floor, the plain version and the backward of
    fp32 masked SDPA over the shard's queries."""
    import torch

    from s2v_torch.kernels import attention_f32 as af
    from s2v_torch.kernels.banded_attention import band_geometry, banded_flash_attention_local
    from s2v_torch.kernels.banded_attention_bwd import (
        banded_flash_attention_local_bwd,
        banded_flash_attention_local_bwd_reference,
    )

    def shard_args(q, k, v, do, geo, f_loc, off):
        band = (geo.global_len, geo.tokens_per_frame, geo.window)
        q_loc, do_loc = _shard_rows(q, geo, f_loc, off), _shard_rows(do, geo, f_loc, off)
        o, lse = banded_flash_attention_local(q_loc, k, v, *band, off, geo.n_frames, return_lse=True)
        return q_loc, k, v, o, lse, do_loc, *band, off, geo.n_frames

    def compare(args, geo, emulate=True):
        got = banded_flash_attention_local_bwd(*args)
        what = f"fp32 banded_flash_attention_local_bwd {tuple(args[0].shape)} offset {args[9]}"
        stats = {n: _agreement_f32(a, r, f"{what} {n}", bwd=True)
                 for n, a, r in zip(("dq", "dk", "dv"), got, banded_flash_attention_local_bwd_reference(*args))}
        if emulate:
            shard = geo.shard(args[9], args[0].shape[1] // geo.tokens_per_frame)
            for n, a, r in zip(("dq", "dk", "dv"), got, af.banded_bwd_f32_blocked(*args[:6], shard)):
                stats[n]["schedule_max_abs_err"] = _agreement_f32(a, r, f"{what} {n} against the emulation",
                                                                  bwd=True)["max_abs_err"]
        return stats

    small = []
    for (b, h, g, tpf, f, w) in BANDED_SMALL_FP32:
        geo = band_geometry(g + f * tpf, g, tpf, w)
        q, k, v = _qkv32(b, g + f * tpf, g + f * tpf, h, g + tpf + f + 5, dev)
        do = torch.randn(q.shape, device=dev, generator=torch.Generator(device=dev).manual_seed(f))
        for ring in (2, 4):
            for r, off, f_loc in _local_f32_shards(ring, f):
                small.append({"band": [b, h, g, tpf, f, w], "ring": ring, "offset": off,
                              **compare(shard_args(q, k, v, do, geo, f_loc, off), geo)})
    emit({"phase": "kernel_banded_local_bwd_fp32_small", "cases": small})

    b, s, h, d = TRAIN_SHAPE
    geo = band_geometry(s, *BAND)
    g_len, tpf = geo.global_len, geo.tokens_per_frame
    q, k, v = _qkv32(b, s, s, h, 11, dev, layer_norm=True)
    do = torch.randn(q.shape, device=dev, generator=torch.Generator(device=dev).manual_seed(12))
    shards = []
    for r, off, f_loc in _local_f32_shards(4, geo.n_frames):
        shard = geo.shard(off, f_loc)
        args = shard_args(q, k, v, do, geo, f_loc, off)
        stats = compare(args, geo, emulate=False)
        ms = _ms3(lambda: banded_flash_attention_local_bwd(*args))
        plain_ms = cuda_ms(lambda: banded_flash_attention_local_bwd_reference(*args), 1)
        rows = torch.arange(g_len + off * tpf, g_len + (off + f_loc) * tpf, device=dev)
        library_ms, library_shape, _ = _masked_sdpa_ms(args[0], k, v, rows, geo, grad=args[5])
        sq = args[0].shape[1]
        flops = 10 * b * h * d * shard.shard_pairs()
        bound_ms, bound_by, one_pass_ms = _f32_bound(flops, (4 * sq + 4 * s) * b * h * d * 4 + b * h * sq * 4)
        shards.append({"rank": r, "offset": off, "local_frames": f_loc,
                       "dummy_frames": f_loc - shard.real_frames(), "grads": stats, "ms": ms, "plain_ms": plain_ms,
                       "library_ms": library_ms, "library_shape": library_shape, "bound_ms": bound_ms,
                       "bound_by": bound_by, "tf32_one_pass_ms": one_pass_ms, "tflops": flops / ms / 1e9})
        if r == 0:
            deterministic = _determinism(banded_flash_attention_local_bwd, args, "fp32 banded_flash_attention_local_bwd")
        del args
    e = FP32_EMULATED_HEADS
    _, off, f_loc = _local_f32_shards(4, geo.n_frames)[0]
    args = shard_args(*(x[:, :, :e].contiguous() for x in (q, k, v, do)), geo, f_loc, off)
    emulated = {n: _agreement_f32(a, r, f"fp32 banded_flash_attention_local_bwd main band {n} against the emulation",
                                  bwd=True)
                for n, a, r in zip(("dq", "dk", "dv"), banded_flash_attention_local_bwd(*args),
                                   af.banded_bwd_f32_blocked(*args[:6], geo.shard(off, f_loc)))}
    result = {"phase": "kernel_banded_local_bwd_fp32_main", "shape": list(TRAIN_SHAPE), "band": list(BAND),
              "dtype": "float32", "ring": 4, "shards": shards, "schedule_rank0": emulated, "emulated_heads": e,
              "deterministic": deterministic,
              "small_worst_err_share": max(_worst(list(c[n] for c in small)) for n in ("dq", "dk", "dv"))}
    emit(result)
    return result


# the fp32 pipeline's latents with B1-B7's fp32 kernels against the same
# pipeline with the chunked backend (PyTorch ops, fp32 with TF32 off): each
# attention call differs by ~3e-6 relative (kernel_fp32), which 6 blocks, 2
# steps and guidance 6 (the uncond/cond difference times up to 2g - 1 = 11)
# carry to ~1e-5; one TF32 pass would give ~1e-2
FP32_PIPELINE_MAX_REL, FP32_PIPELINE_L2 = 1e-3, 1e-4
# the LoRA loss and adapter gradients of the same: the backward's kernels at
# ~3e-6, through remat and 6 blocks
FP32_LOSS_REL, FP32_GRAD_MAX_REL, FP32_GRAD_L2 = 1e-5, 1e-3, 1e-4


def phase_kernel_int8_fp32(dev):
    """Kernel B3 in fp32: its pre-pass kernels (``s2v_int8_prepass_f32``)
    against ``int8_prepass`` bit for bit, and its main kernel (int8 logits
    exact in int32, 3xTF32 P·V) against the plain version within the fp32
    limits, on small ragged shapes (also against the emulation of its
    schedule) and at the main shape B=2, S=19,126, H=48 (two launches bit
    for bit), timed by CUDA events beside its bound: the tensor cores' int8
    logits plus P·V at the 3-pass TF32 floor, against the exponentials on
    the SFUs and the bytes."""
    import torch

    from s2v_torch.kernels import attention_f32 as af
    from s2v_torch.kernels import native
    from s2v_torch.kernels.int8_attention import (
        flash_attention_qk_int8,
        flash_attention_qk_int8_blocked,
        flash_attention_qk_int8_reference,
        int8_prepass,
        launch_int8,
        launch_int8_prepass,
    )

    def compare(q, k, v, emulate=True):
        what = f"fp32 flash_attention_qk_int8 {tuple(q.shape)}x{tuple(k.shape)}"
        o = flash_attention_qk_int8(q, k, v)
        if o.dtype != torch.float32:
            raise AssertionError(f"{what}: output {o.dtype}")
        stats = _agreement_f32(o, flash_attention_qk_int8_reference(q, k, v), what)
        if emulate:
            st = _agreement_f32(o, flash_attention_qk_int8_blocked(q, k, v), what + " against the emulation")
            stats.update(schedule_max_abs_err=st["max_abs_err"], schedule_rel_l2=st["rel_l2"])
        return {**stats, "prepass_bit_equal": _prepass_equal(q, k, what)}

    small = []
    # ragged against the 128-row blocks and 64-key tiles, Sq != Skv both ways, one key tile
    for (b, sq, skv, h) in [(2, 90, 90, 2), (1, 200, 77, 3), (2, 77, 333, 2), (2, 1000, 129, 2), (1, 310, 438, 2)]:
        q, k, v = _qkv32(b, sq, skv, h, sq + skv + 3, dev)
        small.append({"q": [b, sq, h, 64], "skv": skv, **compare(q, k, v)})
    emit({"phase": "kernel_int8_fp32_small", "cases": small})

    b, s, h, d = MAIN_SHAPE
    q, k, v = _qkv32(b, s, s, h, 7, dev, layer_norm=True)
    before = native.launches("flash_attention_qk_int8", "float32")
    stats = compare(q, k, v, emulate=False)
    if native.launches("flash_attention_qk_int8", "float32") != before + 1:
        raise AssertionError("fp32 flash_attention_qk_int8: the fp32 kernel did not launch")
    got, want = launch_int8_prepass(q, k, d ** -0.5), int8_prepass(q, k, d ** -0.5)
    differing = {n: int((a != w).sum()) for n, a, w in zip(("q_i8", "k_i8", "dq"), got, want)}
    del got, want
    first, second = flash_attention_qk_int8(q, k, v), flash_attention_qk_int8(q, k, v)
    if not torch.equal(first, second):
        raise AssertionError("fp32 flash_attention_qk_int8: two launches on the same inputs differ")
    del first, second
    ms = _ms3(lambda: flash_attention_qk_int8(q, k, v))
    prepass_ms = _ms3(lambda: launch_int8_prepass(q, k, d ** -0.5))
    q_i8, k_i8, dq = launch_int8_prepass(q, k, d ** -0.5)
    o = torch.empty_like(q)
    launch_ms = _ms3(lambda: launch_int8(q_i8, k_i8, v, o, dq))
    del q_i8, k_i8, o
    plain_ms = cuda_ms(lambda: flash_attention_qk_int8_reference(q, k, v), 1)
    products = 2 * b * h * s * s * d  # each of q·kᵀ (int8) and P·V (3xTF32)
    logits_ms = products / PEAK_INT8_OPS * 1e3
    pv_ms = TF32_PASSES * products / PEAK_TF32_FLOPS * 1e3
    exp_ms, sfu = _sfu_exp_ms(b * h * s * s)
    bytes_ms = 4 * b * s * h * d * 4 / PEAK_BYTES_PER_S * 1e3  # q, k, v read once and o written once in fp32
    bound_ms, set_by = max((logits_ms + pv_ms, "tensor cores (int8 logits, 3xTF32 P·V)"),
                           (exp_ms, "exponentials (SFU)"), (bytes_ms, "bytes"))
    result = {"phase": "kernel_int8_fp32_main", "shape": list(MAIN_SHAPE), "dtype": "float32", **stats,
              "prepass_values_differing": differing, "deterministic": True, "ms": ms, "prepass_ms": prepass_ms,
              "launch_ms": launch_ms, "plain_ms": plain_ms, "library_ms": None, "bound_ms": bound_ms,
              "bound_by": "bytes" if set_by == "bytes" else "operations", "bound_set_by": set_by,
              "bound_parts_ms": {"int8_logits": logits_ms, "pv_3xtf32": pv_ms, "exponentials": exp_ms,
                                 "bytes": bytes_ms, **sfu},
              "bound_share": bound_ms / ms, "smem_bytes": af.smem_bytes()["int8_fwd"],
              "small_worst_err_share": _worst(small)}
    emit(result)
    return result


# in and out widths of the int8 linears that are not multiples of 8, and the rows
INT8_WIDTHS = [(20, 36, 5), (7, 13, 300), (20, 36, 77)]


def phase_int8_widths(dev):
    """The int8 linears at widths CUDA's ``torch._int_mm`` does not take
    as they are: ``ops/quant.py`` pads them (zero columns, zero rows of q)
    and the card's int32 products must equal the CPU's bit for bit, and
    ``int8_dense``'s fp32 outputs agree with the CPU's."""
    import torch

    from s2v_torch.ops.quant import _int_mm, int8_dense, quantize_weight_int8

    cases = []
    for d_in, d_out, rows in INT8_WIDTHS:
        rng = np.random.RandomState(d_in * d_out + rows)
        xq = torch.from_numpy(rng.randint(-127, 128, (rows, d_in)).astype(np.int8))
        wq8 = torch.from_numpy(rng.randint(-127, 128, (d_out, d_in)).astype(np.int8))
        got = _int_mm(xq.to(dev), wq8.to(dev)).cpu()
        if not (got.dtype == torch.int32 and torch.equal(got, _int_mm(xq, wq8))):
            raise AssertionError(f"int8 product {d_in} -> {d_out} ({rows} rows): the card's differs from the CPU's")
        x = torch.from_numpy(rng.randn(1, rows, d_in).astype(np.float32))
        wq = quantize_weight_int8(torch.from_numpy(0.05 * rng.randn(d_out, d_in).astype(np.float32)))
        y = int8_dense(x.to(dev), {n: t.to(dev) for n, t in wq.items()}).cpu()
        want = int8_dense(x, wq)
        err = ((y - want).abs().max() / want.abs().max()).item()
        if not (y.shape == want.shape and torch.isfinite(y).all() and err <= 1e-6):
            raise AssertionError(f"int8_dense {d_in} -> {d_out}: relative error {err} against the CPU")
        cases.append({"in": d_in, "out": d_out, "rows": rows, "int32_bit_equal": True, "dense_max_rel_err": err})
    result = {"phase": "int8_widths", "cases": cases}
    emit(result)
    return result


def _cast_tree(tree, dtype):
    import torch

    if isinstance(tree, dict):
        return {k: _cast_tree(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cast_tree(v, dtype) for v in tree)
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return tree.to(dtype)
    return tree


def fp32_pipe(pipe, dev):
    """The resident pipeline cast to fp32 (its DiT as the phase's depth cut
    leaves it, T5-XXL ≈ 19 GB, the VAE), as ``--dtype float32`` loads it; the
    caller releases it."""
    import dataclasses

    import torch

    from s2v_torch import S2VPipeline

    t0 = time.perf_counter()
    f32 = torch.float32
    fp = S2VPipeline(
        transformer_params=_cast_tree(pipe.transformer_params, f32),
        transformer_cfg=dataclasses.replace(pipe.transformer_cfg, dtype=f32),
        vae_params=_cast_tree(pipe.vae_params, f32), vae_cfg=dataclasses.replace(pipe.vae_cfg, dtype=f32),
        t5_params=_cast_tree(pipe.t5_params, f32), t5_cfg=dataclasses.replace(pipe.t5_cfg, dtype=f32),
        tokenizer=pipe.tokenizer, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    emit({"phase": "fp32_pipeline", "cast_s": time.perf_counter() - t0,
          "memory_allocated_gb": torch.cuda.memory_allocated() / 1e9 if dev.type == "cuda" else None})
    return fp


def _fp32_counts(counts, backend, forwards, backwards):
    """The launches of ``check_counts``, all of them fp32."""
    if not check_counts(counts, backend, forwards, backwards):
        return False
    return all(counts[f"{name}_by_dtype"].get("float32", 0) == counts[name] for name in ATTENTION_KERNELS)


def phase_e2e_fp32(dev, pipe, backend="flash", height=480, width=720, num_frames=49):
    """``generate`` on the pipeline cast to fp32 (``--dtype float32``) at the
    cut depth, 49x480x720, 2 steps: the exact backend runs B1's fp32 kernel
    once a block and step, and no input is cast down.  Its latents held
    against the ``chunked`` backend's (PyTorch ops) at the same seed; then
    one step each with ``windowed`` (B4 fp32 and B1 fp32 for the global
    queries) and, on the one-rank seq mesh, ``sp_windowed`` (B6 fp32).  The
    clip is the exact run's latents decoded, as ``generate`` decodes them
    for ``output_type="np"``."""
    import torch

    t_phase = time.perf_counter()
    fp = fp32_pipe(pipe, dev)
    L = fp.transformer_cfg.num_layers
    image = np.clip(np.random.RandomState(42).randn(height, width, 3).astype(np.float32) * 0.5, -1, 1)
    kw = dict(prompt="a pig walking in the park", ref_image=image, height=height, width=width,
              num_frames=num_frames, guidance_scale=6.0, seed=42)
    try:
        latents = {}
        for name in (backend, "chunked"):
            fp.set_attention(name)
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats()
            reset_counts()
            t0 = time.perf_counter()
            latents[name] = fp.generate(num_inference_steps=2, output_type="latent", **kw).float()
            if name == backend:
                counts, timings = read_counts(), dict(fp.timings)
                # the clip of the same run: the decode generate runs for output_type="np"
                t1 = time.perf_counter()
                video = fp.decode_latents(latents[name].to(fp.vae_cfg.dtype))
                timings["decode_s"] = time.perf_counter() - t1
                wall_s = time.perf_counter() - t0
                peak_gb = torch.cuda.max_memory_allocated() / 1e9 if dev.type == "cuda" else None
        _clip_checks(video, (1, num_frames, height, width, 3), "e2e_fp32")
        if not _fp32_counts(counts, backend, 2 * L, 0):
            raise AssertionError(f"e2e_fp32 launches {counts}; expected {2 * L} fp32 B1 and nothing else")
        agreement = _agreement_f32(latents[backend], latents["chunked"], "e2e_fp32 latents",
                                   limits=(FP32_PIPELINE_MAX_REL, FP32_PIPELINE_L2))
        legs = {}
        for name in ("windowed", "sp_windowed"):
            if name == "sp_windowed":
                fp.set_mesh(sp_mesh())
            try:
                fp.set_attention(name, 2)
                reset_counts()
                t0 = time.perf_counter()
                fp.generate(num_inference_steps=1, output_type="latent", **kw)
                legs[name] = {"launches": read_counts(), "seconds": time.perf_counter() - t0,
                              "denoise_step_s": fp.timings["denoise_step_s"]}
            finally:
                fp.set_mesh(None)
            if not _fp32_counts(legs[name]["launches"], name, L, 0):
                raise AssertionError(f"e2e_fp32 {name} launches {legs[name]['launches']}")
        int8 = _fp32_int8_legs(fp, dev, kw, latents[backend])
    finally:
        release_pipe(fp, dev, keep_batches=True)
    line = {"phase": "e2e_fp32", "backend": backend, "depth": L, "num_frames": num_frames, "steps": 2,
            "output_shape": list(video.shape), "launches": counts, "encode_prompt_s": timings["encode_prompt_s"],
            "encode_ref_s": timings["encode_ref_s"], "denoise_step_s": timings["denoise_step_s"],
            "decode_s": timings["decode_s"], "wall_s": wall_s, "max_memory_allocated_gb": peak_gb,
            "output_mean": float(video.mean()), "output_std": float(video.std()),
            "latents_vs_chunked": agreement, "windowed_legs": legs, "int8_legs": int8,
            "seconds": time.perf_counter() - t_phase}
    emit(line)
    return {**counts, "windowed": legs["windowed"]["launches"], "sp_windowed": legs["sp_windowed"]["launches"],
            "int8": int8["flash_int8"]["launches"], "sp_int8": int8["sp_int8"]["launches"]}


def _fp32_int8_legs(fp, dev, kw, exact):
    """On the fp32 pipeline's DiT with int8 linears: two steps with
    ``flash_int8`` (B3 fp32 once a block and step) and two with ``sp_int8``
    on the one-rank seq mesh, each finite and counted (fp32 launches only);
    ``sp_int8``'s latents against ``flash_int8``'s within the fp32 pipeline
    limits (one rank: the same values in other buffers), and each int8 run's
    relative RMS against the exact run's latents (``exact``) printed, the
    measure ``reference`` prints for the bf16 int8 path (the JAX package's
    test holds a DiT output to 0.10)."""
    import torch

    params, quantize_s = _quantized(fp)
    exact_params, fp.transformer_params = fp.transformer_params, params
    L = fp.transformer_cfg.num_layers
    legs, latents = {"quantize_s": quantize_s}, {}
    try:
        for name in ("flash_int8", "sp_int8"):
            if name == "sp_int8":
                fp.set_mesh(sp_mesh())
            try:
                fp.set_attention(name)
                reset_counts()
                t0 = time.perf_counter()
                latents[name] = fp.generate(num_inference_steps=2, output_type="latent", **kw).float()
                counts = read_counts()
                seconds = time.perf_counter() - t0
            finally:
                fp.set_mesh(None)
            got = latents[name]
            if not torch.isfinite(got).all():
                raise AssertionError(f"e2e_fp32 {name}: latents not finite")
            if not _fp32_counts(counts, "flash_int8", 2 * L, 0):
                raise AssertionError(f"e2e_fp32 {name} launches {counts}; expected {2 * L} fp32 B3 and nothing else")
            rel_rms = ((got - exact).square().mean().sqrt() / exact.square().mean().sqrt()).item()
            legs[name] = {"launches": counts, "seconds": seconds, "denoise_step_s": fp.timings["denoise_step_s"],
                          "rel_rms_vs_exact": rel_rms}
        legs["sp_int8"]["vs_flash_int8"] = {
            **_agreement_f32(latents["sp_int8"], latents["flash_int8"], "e2e_fp32 sp_int8 latents against flash_int8's",
                             limits=(FP32_PIPELINE_MAX_REL, FP32_PIPELINE_L2)),
            "bitwise_equal": bool(torch.equal(latents["sp_int8"], latents["flash_int8"]))}
    finally:
        fp.transformer_params = exact_params
        fp.set_attention("flash")
    return legs


def phase_train_fp32(dev, pipe, backend="flash", height=480, width=720, num_frames=49):
    """One LoRA loss and its adapters' gradients on the pipeline cast to fp32
    (the trainer's ``--dtype float32 --compute_dtype none``) at the cut
    depth, with remat: B1's fp32 kernel twice a block and B2's once (a first
    run timed apart), held against the ``chunked`` backend's loss and
    gradients; then the same with
    ``windowed`` (B4 and B5 fp32) and, under the one-rank seq mesh,
    ``sp_windowed`` (B6 and B7 fp32)."""
    import dataclasses

    import torch

    from s2v_torch.config import SchedulerConfig
    from s2v_torch.parallel import default_logical_map, mesh_context
    from s2v_torch.schedulers.ddim import compute_alphas_cumprod
    from s2v_torch.training.lora import LoRASpec, init_lora_params

    t_phase = time.perf_counter()
    fp = fp32_pipe(pipe, dev)
    try:
        params, cfg = fp.transformer_params, fp.transformer_cfg
        L = cfg.num_layers
        batch = _lora_batch(fp, height, width, num_frames, seed=8)
        spec = LoRASpec(rank=128, alpha=64.0)
        lora = init_lora_params(torch.Generator(device=dev).manual_seed(1), params, spec)
        for ab in lora.values():  # nonzero b, so that every a gets a gradient
            ab["b"].normal_(0.0, 1e-3, generator=torch.Generator(device=dev).manual_seed(2))
        alphas = torch.as_tensor(compute_alphas_cumprod(SchedulerConfig()), device=dev)
        gen = torch.Generator(device=dev).manual_seed(3)
        timesteps = torch.randint(0, alphas.shape[0], (1,), generator=gen, device=dev)
        noise = torch.randn(batch["video_latents"].shape, generator=gen, device=dev)
        torch.cuda.reset_peak_memory_stats()
        # the first fp32 call of the process's backward pays one-time costs
        # (its workspaces' first allocations): timed apart, then the run held below
        first_s = _loss_and_grads(params, cfg, spec, lora, batch, alphas, timesteps, noise, backend)["seconds"]
        runs = {name: _loss_and_grads(params, cfg, spec, lora, batch, alphas, timesteps, noise, name)
                for name in (backend, "chunked")}
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        wcfg = dataclasses.replace(cfg, attention_window_frames=2)
        runs["windowed"] = _loss_and_grads(params, wcfg, spec, lora, batch, alphas, timesteps, noise, "windowed")
        mesh = sp_mesh()
        with mesh_context(mesh, default_logical_map(mesh)):
            runs["sp_windowed"] = _loss_and_grads(params, wcfg, spec, lora, batch, alphas, timesteps, noise,
                                                  "sp_windowed")
    finally:
        release_pipe(fp, dev, keep_batches=True)
    for name, r in runs.items():
        if name != "chunked" and not _fp32_counts(r["counts"], name, 2 * L, L):
            raise AssertionError(f"train_fp32 {name} launches {r['counts']}")
    ref, got = runs["chunked"], runs[backend]
    names = [f"{n}.{k}" for n in sorted(lora) for k in ("a", "b")]
    loss_rel = abs(got["loss"] - ref["loss"]) / abs(ref["loss"])
    if not loss_rel < FP32_LOSS_REL:
        raise AssertionError(f"train_fp32: loss {got['loss']} against chunked {ref['loss']}")
    grads = {n: _agreement_f32(g, w, f"train_fp32 grad {n}", limits=(FP32_GRAD_MAX_REL, FP32_GRAD_L2))
             for n, g, w in zip(names, got["grads"], ref["grads"])}
    # the windowed pair: the same loss through the band (a different
    # function), finite, its sp_windowed twin within the fp32 kernels' limits
    w, sp = runs["windowed"], runs["sp_windowed"]
    if not (np.isfinite(w["loss"]) and abs(sp["loss"] - w["loss"]) <= FP32_LOSS_REL * abs(w["loss"])):
        raise AssertionError(f"train_fp32: windowed loss {w['loss']}, sp_windowed {sp['loss']}")
    line = {"phase": "train_fp32", "depth": L, "loss": got["loss"], "loss_chunked": ref["loss"],
            "loss_rel_err": loss_rel, "loss_rel_tol": FP32_LOSS_REL,
            "worst_grad": max(grads.values(), key=lambda st: st["rel_l2"]),
            "grad_limits": {"max_rel": FP32_GRAD_MAX_REL, "rel_l2": FP32_GRAD_L2},
            "loss_and_grad_s": {n: r["seconds"] for n, r in runs.items()}, "first_loss_and_grad_s": first_s,
            "launches": {n: r["counts"] for n, r in runs.items()},
            "loss_windowed": w["loss"], "loss_sp_windowed": sp["loss"], "max_memory_allocated_gb": peak_gb,
            "seconds": time.perf_counter() - t_phase}
    emit(line)
    return {"launches": [runs[n]["counts"] for n in (backend, "windowed", "sp_windowed")]}


def phase_ring_past_frames(dev):
    """B6 and B7 in bf16 on the shards of rings with more ranks than latent
    frames (ROADMAP A.9.4): a 4-rank ring over 2 frames, where ranks 2-3
    hold one dummy frame each, and the small geometries whose frames a
    4-rank ring outnumbers; every shard's output, lse and gradients held
    against the plain versions with the bf16 limits (a shard of dummy frames
    only: dq and its dk/dv partials exactly zero)."""
    import torch

    from s2v_torch.kernels import native
    from s2v_torch.kernels.banded_attention import (
        band_geometry,
        banded_flash_attention_local,
        banded_flash_attention_local_reference,
        ring_shards,
    )
    from s2v_torch.kernels.banded_attention_bwd import (
        banded_flash_attention_local_bwd,
        banded_flash_attention_local_bwd_reference,
    )

    before = {n: native.launches(n) for n in ("banded_flash_attention_local", "banded_flash_attention_local_bwd")}
    cases = []
    geometries = [(1, 2, 24, 20, 2, 1)] + [c for c in BANDED_SMALL if c[4] < 4]
    for (b, h, g, tpf, f, w) in geometries:
        geo = band_geometry(g + f * tpf, g, tpf, w)
        q, k, v = _qkv(b, g + f * tpf, g + f * tpf, h, g + tpf + f + 9, dev)
        do = torch.randn(q.shape, device=dev, generator=torch.Generator(device=dev).manual_seed(f + 1)).to(q.dtype)
        _, f_loc = ring_shards(f, 4)
        for r in range(4):
            off = r * f_loc
            q_loc, do_loc = _shard_rows(q, geo, f_loc, off), _shard_rows(do, geo, f_loc, off)
            band = (g, tpf, w)
            o, lse = banded_flash_attention_local(q_loc, k, v, *band, off, f, return_lse=True)
            o_ref, lse_ref = banded_flash_attention_local_reference(q_loc, k, v, *band, off, f, return_lse=True)
            what = f"B6 4-rank ring over {f} frames, rank {r}"
            stats = _agreement(o, o_ref, what)
            lse_err = (lse - lse_ref).abs().max().item()
            if not lse_err < LSE_TOL:
                raise AssertionError(f"{what}: lse max_abs_err {lse_err}")
            args = (q_loc, k, v, o, lse, do_loc, *band, off, f)
            got = banded_flash_attention_local_bwd(*args)
            want = banded_flash_attention_local_bwd_reference(*args)
            grads = {n: _compact(_agreement_or_zero(a, r_, f"B7 4-rank ring over {f} frames, rank {r} {n}"))
                     for n, a, r_ in zip(("dq", "dk", "dv"), got, want)}
            real = geo.shard(off, f_loc).real_frames()
            if real == 0 and any(bool(x.any()) for x in got):
                raise AssertionError(f"B7 rank {r} holds dummy frames only and wrote a nonzero gradient")
            cases.append({"band": [b, h, g, tpf, f, w], "rank": r, "offset": off, "real_frames": real,
                          **_compact(stats), "lse_err": lse_err, "grads": grads})
    launches = {n: native.launches(n) - before[n] for n in before}
    result = {"phase": "ring_past_frames", "ring": 4, "cases": cases, "launches": launches,
              "worst_err_share": max(c["max_abs_err"] / c["max_abs_tol"] for c in cases)}
    emit(result)
    return result


PHASES = ("build", "kernel", "kernel_bwd", "kernel_fp16", "kernel_bwd_fp16", "kernel_banded", "kernel_banded_bwd", "kernel_banded_local",
          "kernel_banded_local_bwd", "kernel_int8", "kernel_int8_fp16", "kernel_banded_fp16", "kernel_banded_bwd_fp16",
          "kernel_banded_local_fp16", "kernel_banded_local_bwd_fp16", "kernel_fp32", "kernel_bwd_fp32",
          "kernel_banded_fp32", "kernel_banded_bwd_fp32", "kernel_banded_local_fp32", "kernel_banded_local_bwd_fp32",
          "kernel_int8_fp32", "int8_widths", "kernel_qk_norm_rope", "kernel_adaln", "ring_past_frames", "reference", "chunked", "e2e", "e2e_windowed", "e2e_sp_windowed",
          "e2e_sp_allgather", "e2e_sp_backends", "e2e_int8", "e2e_mesh", "e2e_mesh_int8", "e2e_options", "turbo",
          "train", "train_windowed", "train_sp_windowed", "train_sp_backends", "train_lora_mesh", "train_qlora",
          "e2e_fp32", "train_fp32", "train_full_5b_fsdp", "variants", "train_remat", "pretrained", "serve", "cli_mesh", "serve_mesh",
          "train_cli_mesh", "train_cli", "e2e_2b", "train_2b", "train_full_2b")
KERNEL_PHASES = {"kernel": phase_kernel, "kernel_bwd": phase_kernel_bwd, "kernel_fp16": phase_kernel_fp16,
                 "kernel_bwd_fp16": phase_kernel_bwd_fp16, "kernel_banded": phase_kernel_banded,
                 "kernel_banded_bwd": phase_kernel_banded_bwd, "kernel_banded_local": phase_kernel_banded_local,
                 "kernel_banded_local_bwd": phase_kernel_banded_local_bwd, "kernel_int8": phase_kernel_int8,
                 "kernel_int8_fp16": phase_kernel_int8_fp16, "kernel_banded_fp16": phase_kernel_banded_fp16,
                 "kernel_banded_bwd_fp16": phase_kernel_banded_bwd_fp16,
                 "kernel_banded_local_fp16": phase_kernel_banded_local_fp16,
                 "kernel_banded_local_bwd_fp16": phase_kernel_banded_local_bwd_fp16,
                 "kernel_fp32": phase_kernel_fp32, "kernel_bwd_fp32": phase_kernel_bwd_fp32,
                 "kernel_banded_fp32": phase_kernel_banded_fp32,
                 "kernel_banded_bwd_fp32": phase_kernel_banded_bwd_fp32,
                 "kernel_banded_local_fp32": phase_kernel_banded_local_fp32,
                 "kernel_banded_local_bwd_fp32": phase_kernel_banded_local_bwd_fp32,
                 "kernel_int8_fp32": phase_kernel_int8_fp32, "int8_widths": phase_int8_widths,
                 "kernel_qk_norm_rope": phase_kernel_qk_norm_rope, "kernel_adaln": phase_kernel_adaln,
                 "ring_past_frames": phase_ring_past_frames,
                 "reference": phase_reference, "chunked": phase_chunked}
# the pipeline phases: the backend each runs
PATH_PHASES = {"e2e": (phase_e2e, "flash"), "e2e_windowed": (phase_e2e, "windowed"),
               "e2e_sp_windowed": (phase_e2e_sp_windowed, "sp_windowed"),
               "e2e_sp_allgather": (phase_e2e_sp_allgather, "sp_allgather"),
               "e2e_sp_backends": (phase_e2e_sp_backends, "sp_ulysses"),
               "train_sp_backends": (phase_train_sp_backends, "sp_allgather"),
               "cli_mesh": (phase_cli_mesh, "flash"), "serve_mesh": (phase_serve_mesh, "flash"),
               "e2e_int8": (phase_e2e_int8, "flash_int8"), "e2e_options": (phase_e2e_options, "flash"),
               "turbo": (phase_turbo, "flash"), "train": (phase_train, "flash"),
               "train_windowed": (phase_train, "windowed"),
               "train_sp_windowed": (phase_train_sp_windowed, "sp_windowed"),
               "train_qlora": (phase_train_qlora, "flash"), "variants": (phase_variants, "flash"),
               "pretrained": (phase_pretrained, "flash"), "serve": (phase_serve, "flash"),
               "e2e_2b": (phase_e2e_2b, "flash"), "train_2b": (phase_train_2b, "flash"),
               "train_remat": (phase_train_remat, "flash"), "train_cli": (phase_train_cli, "flash"),
               "train_full_2b": (phase_train_full_2b, "flash"),
               "e2e_mesh": (phase_e2e_mesh, "sp_allgather"), "e2e_mesh_int8": (phase_e2e_mesh_int8, "flash_int8"),
               "train_lora_mesh": (phase_train_lora_mesh, "flash"),
               "train_full_5b_fsdp": (phase_train_full_5b_fsdp, "flash"),
               "e2e_fp32": (phase_e2e_fp32, "flash"), "train_fp32": (phase_train_fp32, "flash"),
               "train_cli_mesh": (phase_train_cli_mesh, "sp_windowed")}
# the phases on the CogVideoX-2b pipeline, built after the 5b phases (whose
# pipeline is released first) and freed after
PHASES_2B = ("e2e_2b", "train_2b", "train_full_2b")
# the phases on the fp32 cast of the 5b pipeline: their launches are the fp32 rows'
PHASES_FP32 = ("e2e_fp32", "train_fp32")


def _path_launches(results, kernel, skip=()):
    """A kernel's launches on each pipeline phase's run (summed over a
    train phase's steps, the profiled step not included), the phases in
    ``skip`` left out."""
    out = {}
    for phase, r in results.items():
        if phase in skip:
            continue
        if phase.startswith("e2e") or phase == "pretrained":
            out[phase] = r[kernel]
        elif phase == "turbo":
            out["turbo_exact"], out["turbo"] = r["exact"][kernel], r["turbo"][kernel]
        elif phase.startswith("train"):
            out[phase] = sum(c[kernel] for c in r["launches"])
        elif phase == "variants":
            out.update({f"variants_{k}": r[k]["launches"][kernel] for k in ("i2v", "fun_control", "v2v",
                                                                             "disentangled")})
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
    fp16, bwd16 = results["kernel_fp16"], results["kernel_bwd_fp16"]
    small_do = (("dO 2^-10", bwd16["small_do"]), ("train_2b dO", results["train_2b"]["step_do"]))
    s2v16 = fp16["shapes"]["s2v"]
    common = {"route": "cuda", "rel_l2_tol": OUT_L2_REL}
    return [{
        **common,
        "name": "flash_attention",
        "source": "s2v_torch/csrc/flash_attention.cu",
        "headers": ["s2v_torch/csrc/hopper.cuh"],
        "replaces": "s2v_tpu/ops/pallas/flash_attention.py:222",
        "launches": results["e2e"]["flash_attention"],
        "launches_by_path": {**_path_launches(results, "flash_attention", skip=PHASES_2B + PHASES_FP32),
                             **({"pretrained_cli": results["pretrained"]["cli_flash_attention"]}
                                if "pretrained" in results else {}),
                             **({"cli_mesh": results["cli_mesh"]["cli_flash_attention"]}
                                if "cli_mesh" in results else {})},
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
        "dtype": "bfloat16",
    }, {
        **common,
        "name": "flash_attention_fp16",
        "dtype": "float16",
        "source": "s2v_torch/csrc/flash_attention.cu",
        "headers": ["s2v_torch/csrc/hopper.cuh"],
        "replaces": "s2v_tpu/ops/pallas/flash_attention.py:222",
        # the 2b path: t2v and s2v, 2 steps each, 30 blocks
        "launches": results["e2e_2b"]["flash_attention_by_dtype"].get("float16", 0),
        "launches_by_path": {"e2e_2b": results["e2e_2b"]["flash_attention_by_dtype"].get("float16", 0),
                             "train_2b": sum(c["flash_attention_by_dtype"].get("float16", 0)
                                             for c in results["train_2b"]["launches"])},
        "max_abs_err": max(v["max_abs_err"] for sh in fp16["shapes"].values() for v in sh["modes"].values()),
        "max_abs_tol": min(v["max_abs_tol"] for sh in fp16["shapes"].values() for v in sh["modes"].values()),
        "rel_l2": max(v["rel_l2"] for sh in fp16["shapes"].values() for v in sh["modes"].values()),
        "ms": s2v16["modes"][MAIN_MODE]["ms"],
        "plain_ms": s2v16["plain_ms"],
        "bound_ms": s2v16["bound_ms"],
        "bound_by": s2v16["bound_by"],
        "library_ms": s2v16["library_ms"],
        "mode": MAIN_MODE,
        "ms_by_shape_and_mode": {n: {m: v["ms"] for m, v in sh["modes"].items()} for n, sh in fp16["shapes"].items()},
        "bound_ms_by_shape": {n: sh["bound_ms"] for n, sh in fp16["shapes"].items()},
        "library_ms_by_shape": {n: sh["library_ms"] for n, sh in fp16["shapes"].items()},
        "tflops": s2v16["modes"][MAIN_MODE]["tflops"],
        "shape": s2v16["shape"],
    }, {
        **common,
        "name": "flash_attention_bwd",
        "source": "s2v_torch/csrc/flash_attention_bwd.cu",
        "headers": ["s2v_torch/csrc/hopper.cuh"],
        "replaces": "s2v_tpu/ops/pallas/flash_attention_bwd.py:128",
        "launches": sum(c["flash_attention_bwd"] for c in results["train"]["launches"]),
        "launches_by_path": _path_launches(results, "flash_attention_bwd", skip=PHASES_2B + PHASES_FP32),
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
        "dtype": "bfloat16",
    }, {
        **common,
        "name": "flash_attention_bwd_fp16",
        "dtype": "float16",
        "source": "s2v_torch/csrc/flash_attention_bwd.cu",
        "headers": ["s2v_torch/csrc/hopper.cuh"],
        "replaces": "s2v_tpu/ops/pallas/flash_attention_bwd.py:128",
        "launches": sum(c["flash_attention_bwd_by_dtype"].get("float16", 0) for c in results["train_2b"]["launches"]),
        "launches_by_path": {"train_2b": sum(c["flash_attention_bwd_by_dtype"].get("float16", 0)
                                             for c in results["train_2b"]["launches"])},
        "max_abs_err": worst(bwd16["grads"], "max_abs_err"),
        "max_abs_tol": min(v["max_abs_tol"] for v in bwd16["grads"].values()),
        "rel_l2": worst(bwd16["grads"], "rel_l2"),
        "ms": bwd16["ms"],
        "plain_ms": bwd16["plain_ms"],
        "bound_ms": bwd16["bound_ms"],
        "bound_by": bwd16["bound_by"],
        "library_ms": bwd16["library_ms"],
        "tflops": bwd16["tflops"],
        "parts_ms": bwd16["parts_ms"],
        "deterministic": bwd16["deterministic"],
        "schedule_max_abs_err": max(v["schedule_max_abs_err"] for v in bwd16["grads"].values()),
        "small_do_rel_l2": {src: {g: d[g]["rel_l2"] for g in ("dq", "dk", "dv")} for src, d in small_do},
        "small_do_zero_share": {src: {g: d[g]["zero_share"] for g in ("dq", "dk", "dv")} for src, d in small_do},
        "shape": list(TRAIN_SHAPE_2B),
    }, {
        **common,
        "name": "banded_flash_attention",
        "source": "s2v_torch/csrc/banded_attention.cu",
        "headers": ["s2v_torch/csrc/hopper.cuh", "s2v_torch/csrc/band.cuh"],
        "replaces": "s2v_tpu/ops/pallas/banded_attention.py:155",
        "launches": results["e2e_windowed"]["banded_flash_attention"],
        "launches_by_path": _path_launches(results, "banded_flash_attention", skip=PHASES_FP32),
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
        "launches_by_path": _path_launches(results, "banded_flash_attention_bwd", skip=PHASES_FP32),
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
        "launches_by_path": _path_launches(results, "banded_flash_attention_local", skip=PHASES_FP32),
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
        "launches_by_path": _path_launches(results, "banded_flash_attention_local_bwd", skip=PHASES_FP32),
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
    }, _qk_norm_rope_row(results, common), _adaln_row(results, common), *_fp16_rows(results, common),
        *_fp32_rows(results, common)]


def _qk_norm_rope_row(results, common):
    """The kernels line's row of the q/k LayerNorms and RoPE kernel: the
    port's own, with no Pallas counterpart; its launches on the 5b and 2b
    generate paths (42 and 30 a step at full depth), none on the LoRA
    step, and its times at both shapes beside the bound."""
    qk = results["kernel_qk_norm_rope"]
    main = qk["main"]
    return {
        **common,
        "name": "qk_norm_rope",
        "source": "s2v_torch/csrc/qk_norm_rope.cu",
        "headers": ["s2v_torch/csrc/hopper.cuh"],
        "replaces": None,
        "replaces_note": "no Pallas kernel: the JAX package leaves the q/k norms and RoPE to XLA",
        "launches": results["e2e"]["qk_norm_rope"],
        "launches_e2e_2b": results["e2e_2b"]["qk_norm_rope"],
        "launches_train": sum(c["qk_norm_rope"] for c in results["train"]["launches"]),
        "max_abs_err": max(main[m][t][ref]["max_abs_err"] for m in main for t in "qk" for ref in ("emulated", "plain")),
        "rel_l2": max(main[m][t][ref]["rel_l2"] for m in main for t in "qk" for ref in ("emulated", "plain")),
        **{f"ms_{m}": main[m]["ms"] for m in main},
        **{f"bound_ms_{m}": main[m]["bound_ms"] for m in main},
        **{f"plain_ms_{m}": main[m]["plain_ms"] for m in main},
        "bound_by": "bytes",
        "library_ms": None,
        "library_note": "no PyTorch call computes the q/k norms and RoPE together",
        "shape": list(MAIN_SHAPE),
        "shape_2b": list(SHAPES_2B["s2v"]),
    }


def _adaln_row(results, common):
    """The kernels line's row of the adaLN-Zero LayerNorms, modulation and
    stream join kernel: the port's own, with no Pallas counterpart; its
    launches on the 5b and 2b generate paths (two a block and the output
    norm a forward), none on the LoRA step, and its times at the 5b, 2b
    and 1.5 shapes beside the bound and a copy of the same bytes."""
    main = results["kernel_adaln"]["main"]
    return {
        **common,
        "name": "adaln_zero",
        "source": "s2v_torch/csrc/adaln.cu",
        "headers": ["s2v_torch/csrc/hopper.cuh"],
        "replaces": None,
        "replaces_note": "no Pallas kernel: the JAX package leaves the adaLN norms and modulation to XLA",
        "launches": results["e2e"]["adaln"],
        "launches_e2e_2b": results["e2e_2b"]["adaln"],
        "launches_train": sum(c["adaln"] for c in results["train"]["launches"]),
        "max_abs_err": max(main[m]["plain"]["max_abs_err"] for m in main),
        "rel_l2": max(main[m]["plain"]["rel_l2"] for m in main),
        "ulps_from_emulation": max(main[m]["ulps_from_emulation"] for m in main),
        **{f"ms_{m}": main[m]["ms"] for m in main},
        **{f"bound_ms_{m}": main[m]["bound_ms"] for m in main},
        **{f"plain_ms_{m}": main[m]["plain_ms"] for m in main},
        **{f"copy_ms_{m}": main[m]["copy_ms"] for m in main},
        "bound_by": "bytes",
        "library_ms": None,
        "library_note": "no PyTorch call computes the LayerNorm, the modulation and the join together",
        "shapes": {m: [main[m]["batch"], sum(main[m]["lens"]), main[m]["dim"]] for m in main},
    }


def _fp32_rows(results, common):
    """The kernels line's rows of B1-B7 in fp32: launches on the fp32
    pipeline's paths (``e2e_fp32`` and its windowed and int8 legs,
    ``train_fp32``), agreement and times from the fp32 kernel phases at the
    main shapes (B6/B7: rank 0's shard of a 4-rank ring, every shard
    listed)."""
    e2e, train = results["e2e_fp32"], results["train_fp32"]["launches"]  # train: flash, windowed, sp_windowed
    f32 = lambda counts, name: counts[f"{name}_by_dtype"].get("float32", 0)  # noqa: E731
    fwd, bwd = results["kernel_fp32"], results["kernel_bwd_fp32"]
    banded, banded_bwd = results["kernel_banded_fp32"], results["kernel_banded_bwd_fp32"]
    local, local_bwd = results["kernel_banded_local_fp32"], results["kernel_banded_local_bwd_fp32"]
    int8 = results["kernel_int8_fp32"]
    times = ("ms", "plain_ms", "bound_ms", "bound_by", "tf32_one_pass_ms", "library_ms", "tflops")

    def grads_worst(stats, key):
        return max(v[key] for v in stats.values())

    def shard_fields(r, grads):
        worst = (lambda sh: grads_worst(sh["grads"], "max_abs_err")) if grads else (lambda sh: sh["max_abs_err"])
        first = r["shards"][0]
        return {**{k: first[k] for k in times}, "max_abs_err": max(worst(sh) for sh in r["shards"]),
                "per_shard_ring4": [{k: sh[k] for k in ("rank", "offset", "dummy_frames", "ms", "plain_ms",
                                                        "bound_ms", "tf32_one_pass_ms", "library_ms")}
                                    for sh in r["shards"]]}

    rows = [
        ("flash_attention_fp32", "attention_f32.cu", "s2v_tpu/ops/pallas/flash_attention.py:222",
         {"e2e_fp32": f32(e2e, "flash_attention"), "train_fp32": f32(train[0], "flash_attention")},
         {"max_abs_err": max(m["max_abs_err"] for m in fwd["modes"].values()),
          "rel_l2": max(m["rel_l2"] for m in fwd["modes"].values()), **{k: fwd[k] for k in times if k != "ms"},
          "ms": fwd["modes"][MAIN_MODE]["ms"], "ms_online": fwd["modes"]["online"]["ms"], "mode": MAIN_MODE,
          "shape": list(MAIN_SHAPE), "max_abs_tol_rel": FP32_FWD_MAX_REL, "rel_l2_tol": FP32_FWD_L2}),
        ("flash_attention_bwd_fp32", "attention_f32_bwd.cu", "s2v_tpu/ops/pallas/flash_attention_bwd.py:128",
         {"train_fp32": f32(train[0], "flash_attention_bwd")},
         {"max_abs_err": grads_worst(bwd["grads"], "max_abs_err"), "rel_l2": grads_worst(bwd["grads"], "rel_l2"),
          **{k: bwd[k] for k in times}, "parts_ms": bwd["parts_ms"], "deterministic": bwd["deterministic"],
          "shape": list(TRAIN_SHAPE), "max_abs_tol_rel": FP32_BWD_MAX_REL, "rel_l2_tol": FP32_BWD_L2}),
        ("flash_attention_qk_int8_fp32", "attention_f32.cu", "s2v_tpu/ops/pallas/int8_attention.py:99",
         {"e2e_fp32_int8": f32(e2e["int8"], "flash_attention_qk_int8"),
          "e2e_fp32_sp_int8": f32(e2e["sp_int8"], "flash_attention_qk_int8")},
         {**{k: int8[k] for k in ("max_abs_err", "rel_l2", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                  "launch_ms", "prepass_ms", "bound_set_by", "bound_parts_ms",
                                  "prepass_bit_equal", "prepass_values_differing")},
          "prepass_source": "s2v_torch/csrc/int8_attention.cu", "shape": list(MAIN_SHAPE),
          "max_abs_tol_rel": FP32_FWD_MAX_REL, "rel_l2_tol": FP32_FWD_L2}),
        ("banded_flash_attention_fp32", "attention_f32.cu", "s2v_tpu/ops/pallas/banded_attention.py:155",
         {"e2e_fp32_windowed": f32(e2e["windowed"], "banded_flash_attention"),
          "train_fp32_windowed": f32(train[1], "banded_flash_attention")},
         {"max_abs_err": banded["max_abs_err"], "rel_l2": banded["rel_l2"], **{k: banded[k] for k in times},
          "library_covers": banded["library_covers"], "library_shape": banded["library_shape"],
          "shape": list(MAIN_SHAPE), "band": list(BAND), "max_abs_tol_rel": FP32_FWD_MAX_REL,
          "rel_l2_tol": FP32_FWD_L2}),
        ("banded_flash_attention_bwd_fp32", "attention_f32_bwd.cu", "s2v_tpu/ops/pallas/banded_attention_bwd.py:178",
         {"train_fp32_windowed": f32(train[1], "banded_flash_attention_bwd")},
         {"max_abs_err": grads_worst(banded_bwd["grads"], "max_abs_err"),
          "rel_l2": grads_worst(banded_bwd["grads"], "rel_l2"), **{k: banded_bwd[k] for k in times},
          "library_covers": banded_bwd["library_covers"], "library_shape": banded_bwd["library_shape"],
          "deterministic": banded_bwd["deterministic"], "shape": list(TRAIN_SHAPE), "band": list(BAND),
          "max_abs_tol_rel": FP32_BWD_MAX_REL, "rel_l2_tol": FP32_BWD_L2}),
        ("banded_flash_attention_local_fp32", "attention_f32.cu", "s2v_tpu/ops/pallas/banded_attention.py:281",
         {"e2e_fp32_sp_windowed": f32(e2e["sp_windowed"], "banded_flash_attention_local"),
          "train_fp32_sp_windowed": f32(train[2], "banded_flash_attention_local")},
         {**shard_fields(local, False), "shape": list(MAIN_SHAPE), "band": list(BAND), "ring": 4,
          "max_abs_tol_rel": FP32_FWD_MAX_REL, "rel_l2_tol": FP32_FWD_L2}),
        ("banded_flash_attention_local_bwd_fp32", "attention_f32_bwd.cu",
         "s2v_tpu/ops/pallas/banded_attention_bwd.py:375",
         {"train_fp32_sp_windowed": f32(train[2], "banded_flash_attention_local_bwd")},
         {**shard_fields(local_bwd, True), "deterministic": local_bwd["deterministic"], "shape": list(TRAIN_SHAPE),
          "band": list(BAND), "ring": 4, "max_abs_tol_rel": FP32_BWD_MAX_REL, "rel_l2_tol": FP32_BWD_L2}),
    ]
    return [{**common, "name": name, "dtype": "float32", "source": f"s2v_torch/csrc/{src}",
             "headers": ["s2v_torch/csrc/attention_f32.cuh", "s2v_torch/csrc/band.cuh"], "replaces": replaces,
             "launches": sum(by_path.values()), "launches_by_path": by_path, **fields}
            for name, src, replaces, by_path, fields in rows]


def _fp16_rows(results, common):
    """The kernels line's rows of B3-B7 in fp16: launches on the 2b paths
    (``e2e_2b``'s opt-in steps, ``train_2b``'s windowed and sp_windowed
    steps), agreement and times from the fp16 kernel phases."""
    opt_e2e = results["e2e_2b"]["opt_ins"]
    opt_train = results["train_2b"]["opt_ins"]
    fp16 = lambda counts, name: counts[f"{name}_by_dtype"].get("float16", 0)  # noqa: E731

    def grads_worst(stats, key):
        return max(v[key] for v in stats.values())

    int8, banded, banded_bwd = (results[k] for k in ("kernel_int8_fp16", "kernel_banded_fp16",
                                                      "kernel_banded_bwd_fp16"))
    local, local_bwd = results["kernel_banded_local_fp16"], results["kernel_banded_local_bwd_fp16"]
    times = lambda r: {k: r[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}  # noqa: E731
    rows = [
        ("flash_attention_qk_int8_fp16", "int8_attention.cu", "s2v_tpu/ops/pallas/int8_attention.py:99",
         {"e2e_2b_int8": fp16(opt_e2e["flash_int8"]["launches"], "flash_attention_qk_int8")},
         {**{k: int8[k] for k in ("max_abs_err", "max_abs_tol", "rel_l2")}, **times(int8),
          "b1_online_ms": int8["b1_online_ms"], "bound_set_by": int8["bound_set_by"],
          "prepass_bit_equal": int8["prepass_bit_equal"], "shape": int8["shape"]}),
        ("banded_flash_attention_fp16", "banded_attention.cu", "s2v_tpu/ops/pallas/banded_attention.py:155",
         {"e2e_2b_windowed": fp16(opt_e2e["windowed"]["launches"], "banded_flash_attention"),
          "train_2b_windowed": sum(fp16(c, "banded_flash_attention") for c in opt_train["windowed"]["launches"])},
         {**{k: banded[k] for k in ("max_abs_err", "max_abs_tol", "rel_l2")}, **times(banded),
          "video_launch_ms": banded["video_launch_ms"], "shape": banded["shape"], "band": list(BAND)}),
        ("banded_flash_attention_bwd_fp16", "banded_attention_bwd.cu",
         "s2v_tpu/ops/pallas/banded_attention_bwd.py:178",
         {"train_2b_windowed": sum(fp16(c, "banded_flash_attention_bwd") for c in opt_train["windowed"]["launches"])},
         {"max_abs_err": grads_worst(banded_bwd["grads"], "max_abs_err"),
          "max_abs_tol": min(v["max_abs_tol"] for v in banded_bwd["grads"].values()),
          "rel_l2": grads_worst(banded_bwd["grads"], "rel_l2"), **times(banded_bwd),
          "video_launch_ms": banded_bwd["video_launch_ms"], "video_parts_ms": banded_bwd["video_parts_ms"],
          "at_small_do": banded_bwd["at_small_do"], "shape": banded_bwd["shape"], "band": list(BAND)}),
        ("banded_flash_attention_local_fp16", "banded_attention.cu", "s2v_tpu/ops/pallas/banded_attention.py:281",
         {"e2e_2b_sp_windowed": fp16(opt_e2e["sp_windowed"]["launches"], "banded_flash_attention_local"),
          "train_2b_sp_windowed": sum(fp16(c, "banded_flash_attention_local")
                                      for c in opt_train["sp_windowed"]["launches"])},
         {**{k: local[k] for k in ("max_abs_err", "max_abs_tol", "rel_l2")}, **times(local),
          "q_shape": local["q_shape"], "shape": local["shape"], "band": list(BAND)}),
        ("banded_flash_attention_local_bwd_fp16", "banded_attention_bwd.cu",
         "s2v_tpu/ops/pallas/banded_attention_bwd.py:375",
         {"train_2b_sp_windowed": sum(fp16(c, "banded_flash_attention_local_bwd")
                                      for c in opt_train["sp_windowed"]["launches"])},
         {"max_abs_err": grads_worst(local_bwd["grads"], "max_abs_err"),
          "max_abs_tol": min(v["max_abs_tol"] for v in local_bwd["grads"].values()),
          "rel_l2": grads_worst(local_bwd["grads"], "rel_l2"), **times(local_bwd),
          "q_shape": local_bwd["q_shape"], "shape": local_bwd["shape"], "band": list(BAND)}),
    ]
    return [{**common, "name": name, "dtype": "float16", "source": f"s2v_torch/csrc/{src}",
             "headers": ["s2v_torch/csrc/hopper.cuh"] + (["s2v_torch/csrc/band.cuh"] if "banded" in src else []),
             "replaces": replaces, "launches": sum(by_path.values()), "launches_by_path": by_path, **fields}
            for name, src, replaces, by_path, fields in rows]


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
    results, pipe, pipe_2b = {}, None, None
    phase_s = {}
    try:
        for phase in [p for p in PHASES if p in phases and p != "build"]:
            t_phase = time.perf_counter()
            if phase in KERNEL_PHASES:
                results[phase] = KERNEL_PHASES[phase](dev)
                phase_s[phase] = time.perf_counter() - t_phase
                continue
            fn, backend = PATH_PHASES[phase]
            if phase in PHASES_2B:
                if pipe is not None:
                    release_pipe(pipe, dev)
                    pipe = None
                pipe_2b = pipe_2b or build_2b_pipe(dev)
                with cut_depth(pipe_2b, DEPTH_CUT.get(phase)):
                    results[phase] = fn(dev, pipe_2b, backend)
            else:
                pipe = pipe or build_full_pipe(dev)
                with cut_depth(pipe, DEPTH_CUT.get(phase)):
                    results[phase] = fn(dev, pipe, backend)
            if phase in DEPTH_CUT:
                results[phase]["depth"] = DEPTH_CUT[phase]  # for the kernels line's launches
            phase_s[phase] = time.perf_counter() - t_phase
        if pipe_2b is not None:
            release_pipe(pipe_2b, dev)
    finally:
        remove_smoke_files()
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
    if "e2e" in results and "e2e_sp_allgather" in results:
        # the same seed through B1 (flash) and through sp_allgather on one rank
        emit(sp_allgather_vs_e2e(results["e2e_sp_allgather"], results["e2e"]))
    if "e2e_mesh" in results and "e2e_sp_allgather" in results:
        # the same seed on the one-rank dp1,sp1,tp1 mesh (DiT and T5 sliced) and on the sp1 ring
        emit(mesh_vs_single(results["e2e_mesh"], results["e2e_sp_allgather"], "e2e_mesh"))
    if "e2e_mesh_int8" in results and "e2e_int8" in results:
        emit(mesh_vs_single(results["e2e_mesh_int8"], results["e2e_int8"], "e2e_mesh_int8"))
    if any(p in results for p in ("e2e_sp_allgather", "e2e_sp_backends", "train_sp_backends", "e2e_mesh",
                                  "train_lora_mesh", "train_full_5b_fsdp", "train_cli_mesh")):
        emit({"phase": "seq_rings", "rings_run_on_this_card": [1], "data_and_model_dims_run_on_this_card": [1],
              "note": "no mesh dim above 1 ran on this card: one card, and NCCL takes one rank per device; seq "
                      "rings of 2 and 4 and data and model dims of 2 run only in the CPU tests (gloo)"})
    if "train_qlora" in results:
        # a finding, not a gate: the JAX package's test holds the QLoRA loss
        # to rtol 0.05 of the bf16-base loss on its tiny model
        exact, qlora = results["train_qlora"]["first_loss_exact"], results["train_qlora"]["losses"][0]
        emit({"phase": "qlora_vs_exact", "first_loss_exact": exact, "first_loss_qlora": qlora,
              "relative": abs(qlora / exact - 1), "jax_test_rtol": 0.05})
    emit({"phase": "phase_seconds", "seconds": phase_s, "total_s": time.perf_counter() - t_start})
    if phases != list(PHASES):
        print(smi, flush=True)
        return 0
    emit({"kernels": kernels_line(results), "seconds": time.perf_counter() - t_start})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
