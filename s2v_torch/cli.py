"""Inference CLI of the port, flag for flag the JAX package's
(``s2v_tpu/cli.py``, itself the reference inference script's flags):

    python -m s2v_torch.cli \\
        --pretrained_model_name_or_path /path/to/CogVideoX-5b-snapshot \\
        --checkpoint_path /path/to/s2v_lora_ckpt \\
        --ref_img_path ./samples/pig.png \\
        --prompt "<cls> A pig walking on a beach" \\
        --output_dir ./out

It loads the snapshot (merging the LoRA checkpoint), generates one clip on
the CUDA card and writes ``<output_dir>/output.mp4``.  ``--device cpu``, the
port's own flag, runs on the CPU instead; without a card and without it the
CLI raises.  ``--attention_backend`` takes the JAX names: ``auto`` is the
flash kernel on CUDA and the plain attention on the CPU, ``pallas`` is
``flash``, ``pallas_int8`` ``flash_int8``, ``xla`` ``plain``,
``windowed_xla`` ``windowed_plain``, ``chunked`` ``chunked``.  With
``--segment_steps N`` the loop runs in host-stepped segments and a line
``[s2v_torch] denoise i/n steps (+Ns)`` is printed after each; ``--progress``
writes a per-step line on stderr.  ``--pipeline t2v`` generates from the
prompt alone (no subject image; ``pipelines/variants.py::generate_t2v``),
``--disentangled_modulation`` keeps the pre-merge adaLN linears for the
video and text streams, ``--dtype float16`` (the 2b family's published
type) runs on the card through the fp16 kernels B1/B2, and ``--dtype
float32`` through the fp32 kernels (B1, B4, B6 as 3xTF32; the int8 B3 of
``--attention_backend pallas_int8`` with exact int32 logits and a 3xTF32
P·V).

Across cards: ``torchrun --nproc_per_node N -m s2v_torch.cli --mesh
dp<a>,tp<b>,sp<c> ...`` (a·b·c = N) generates one clip over N cards (one
process each): a ``data`` dim splits the batched CFG's rows, a ``model`` dim
runs megatron TP on sliced DiT params (and with ``--text_encoder_device
mesh`` on sliced T5 params), a ``seq`` dim shards the DiT's video frames,
where the exact backend becomes ``sp_allgather`` (or pass ``sp_ulysses``,
``ring``, ``sp_int8``, ``sp_windowed``) and the VAE decode runs
context-parallel where the ring can take it.  Every rank runs the same
generate; rank 0 alone prints and writes the clip.  A one-rank mesh
(``--mesh tp1``, ``sp1``) runs without ``torchrun``.
"""

from __future__ import annotations

import argparse
import json
import os
import time

from s2v_torch.cli_utils import (
    ATTENTION_BACKEND_CHOICES,
    BACKEND_NAMES,
    check_mesh_flags,
    str2bool as _str2bool,
    tiling_policy as _tiling_policy,
)


def get_args(argv=None):
    p = argparse.ArgumentParser(description="Disentangled subject-to-video inference (PyTorch/CUDA)")
    p.add_argument("--pretrained_model_name_or_path", type=str, default="THUDM/CogVideoX-5b",
                   help="Local HF snapshot dir with transformer/ vae/ text_encoder/ tokenizer/ scheduler/, "
                        "or a hub repo id")
    p.add_argument("--cache_dir", type=str, default=None)
    p.add_argument("--dataset_name", type=str, default="customization")
    p.add_argument("--dataloader_num_workers", type=int, default=16)
    p.add_argument("--ref_img_path", type=str, default=None,
                   help="subject reference image (required unless --pipeline t2v)")
    p.add_argument("--pipeline", type=str, default="s2v", choices=("s2v", "t2v"),
                   help="s2v = subject-conditioned; t2v = text-to-video, no subject image")
    p.add_argument("--guidance_scale", type=float, default=6.0)
    p.add_argument("--use_dynamic_cfg", action="store_true", default=False)
    p.add_argument("--seed", type=int, default=420)
    p.add_argument("--rank", type=int, default=128)
    p.add_argument("--lora_alpha", type=float, default=64)
    p.add_argument("--output_dir", type=str, default="cogvideox-lora")
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--width", type=int, default=720)
    p.add_argument("--fps", type=int, default=8)
    p.add_argument("--max_num_frames", type=int, default=49)
    p.add_argument("--skip_frames_start", type=int, default=0)
    p.add_argument("--skip_frames_end", type=int, default=0)
    p.add_argument("--enable_slicing", type=_str2bool, default=True)
    p.add_argument("--enable_tiling", type=_tiling_policy, default="auto",
                   help="true | false | auto (default: tile only above the VAE's native size)")
    p.add_argument("--hub_model_id", type=str, default=None)
    p.add_argument("--local_reference_scale", type=float, default=1.0)  # inert in the reference too
    p.add_argument("--checkpoint_path", type=str, default=None, help="S2V LoRA checkpoint dir")
    p.add_argument("--prompt", type=str, default="")
    p.add_argument("--num_inference_steps", type=int, default=50)
    p.add_argument("--use_dpm", action="store_true", default=False,
                   help="DPM-Solver++(2M)-style stochastic sampler instead of DDIM")
    p.add_argument("--attention_backend", type=str, default="auto", choices=ATTENTION_BACKEND_CHOICES,
                   help="auto = the flash kernel on CUDA, plain attention on the CPU (JAX names, see the module doc)")
    p.add_argument("--attention_window", type=int, default=2,
                   help="half-width (latent frames) for --attention_backend windowed")
    p.add_argument("--quantize_int8", action="store_true", default=False,
                   help="int8 linears in the DiT (pair with --attention_backend pallas_int8 for int8-QK attention)")
    p.add_argument("--text_encoder_device", type=str, default="auto", choices=["auto", "device", "host", "mesh"],
                   help="host keeps T5 on the CPU in fp32; mesh slices it over --mesh's model dim")
    p.add_argument("--disentangled_modulation", action="store_true", default=False,
                   help="video/text modulated by the pre-merge adaLN linears, the ref stream by the LoRA-merged ones")
    p.add_argument("--dtype", type=str, default="bfloat16", choices=["bfloat16", "float16", "float32"],
                   help="model dtype; on the card every attention kernel takes bfloat16, float16 and float32 "
                        "(3xTF32 products; pallas_int8's logits stay exact int32)")
    p.add_argument("--adaptive_threshold", type=float, default=0.0,
                   help="opt-in step skipping (bounded-difference criterion); 0 = the exact loop. Try 0.01-0.02")
    p.add_argument("--cfg_skip_threshold", type=float, default=0.0,
                   help="opt-in cfg-skip: skip the uncond forward once the dynamic guidance scale has decayed to "
                        "g - 1 < threshold (error bounded by (g - 1)·|cond - uncond|); 0 = off. Try 0.01")
    p.add_argument("--segment_steps", type=int, default=0,
                   help=">0: run the denoise loop in host-stepped segments of N steps, with a progress line after each")
    p.add_argument("--mesh", type=str, default=None,
                   help="mesh over the processes torchrun started, one per card, e.g. dp2,tp2 or sp4 (data: the "
                        "CFG batch, model: megatron TP, seq: video frames)")
    p.add_argument("--progress", action="store_true", default=False, help="a per-step progress line on stderr")
    p.add_argument("--profile_dir", type=str, default=None,
                   help="write a torch.profiler trace of the generate call (trace.json) here and print its "
                        "s2v.* spans (calls, host ms, device ms, self device ms)")
    p.add_argument("--save_merged_dir", type=str, default=None,
                   help="also export the loaded (LoRA-merged) weights as an HF-layout snapshot to this dir "
                        "(save_pretrained)")
    p.add_argument("--compilation_cache_dir", type=str, default="auto",
                   help="accepted for the JAX CLI's command lines and ignored: the port compiles no XLA programs")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None):
    args = argv if isinstance(argv, argparse.Namespace) else get_args(argv)
    check_mesh_flags(args)
    if args.pipeline != "t2v" and not args.ref_img_path:
        raise SystemExit("--ref_img_path is required (or use --pipeline t2v)")
    os.makedirs(args.output_dir, exist_ok=True)

    from s2v_torch.parallel.sharding import entry_point_mesh
    from s2v_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    with entry_point_mesh(args.mesh, device.type) as mesh:
        _generate(args, device, mesh)


def _generate(args, device, mesh):
    """Load, generate and (on rank 0) write the clip."""
    import torch

    from s2v_torch.parallel.multihost import is_main_process
    from s2v_torch.pipelines.s2v import S2VPipeline
    from s2v_torch.utils.video import export_to_video, to_uint8_frames

    main_rank = is_main_process()
    say = print if main_rank else (lambda *a, **k: None)
    t0 = time.perf_counter()
    pipe = S2VPipeline.from_pretrained(
        os.path.expanduser(args.pretrained_model_name_or_path),
        lora_checkpoint=args.checkpoint_path,
        lora_alpha=args.lora_alpha,
        attention_backend=BACKEND_NAMES[args.attention_backend],
        quantize_int8=args.quantize_int8,
        text_encoder_device=args.text_encoder_device,
        disentangled_modulation=args.disentangled_modulation,
        dtype=getattr(torch, args.dtype),
        mesh=mesh,
        cache_dir=os.path.expanduser(args.cache_dir) if args.cache_dir else None,
        device=device,
    )
    pipe.vae_tiling = args.enable_tiling
    pipe.vae_slicing = bool(args.enable_slicing)
    pipe.set_attention(BACKEND_NAMES[args.attention_backend], args.attention_window)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    where = f"{device} ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else str(device)
    on_mesh = f", mesh {args.mesh}, seq ring of {pipe._seq_ring()}" if mesh is not None else ""
    say(f"[s2v_torch] models loaded in {time.perf_counter() - t0:.1f}s on {where}{on_mesh}", flush=True)

    if args.save_merged_dir:
        pipe.save_pretrained(os.path.expanduser(args.save_merged_dir), write=main_rank)
        say(f"[s2v_torch] merged snapshot written to {args.save_merged_dir}")

    profiler = None
    if args.profile_dir and main_rank:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
        profiler = profile(activities=activities)
        profiler.start()
    t1 = time.perf_counter()
    progress = None
    if args.segment_steps > 0:
        last = [t1]

        def progress(i, _latents):
            now = time.perf_counter()
            say(f"[s2v_torch] denoise {i}/{args.num_inference_steps} steps (+{now - last[0]:.0f}s)", flush=True)
            last[0] = now

    if args.pipeline == "t2v":
        from s2v_torch.pipelines.variants import generate_t2v

        video = generate_t2v(
            pipe,
            prompt=args.prompt,
            height=args.height,
            width=args.width,
            num_frames=args.max_num_frames,
            num_inference_steps=args.num_inference_steps,
            guidance_scale=args.guidance_scale,
            use_dynamic_cfg=args.use_dynamic_cfg,
            seed=args.seed,
        )
    else:
        video = pipe.generate(
            prompt=args.prompt,
            ref_image=args.ref_img_path,
            height=args.height,
            width=args.width,
            num_frames=args.max_num_frames,
            num_inference_steps=args.num_inference_steps,
            guidance_scale=args.guidance_scale,
            use_dynamic_cfg=args.use_dynamic_cfg,
            use_dpm=args.use_dpm,
            seed=args.seed,
            adaptive_threshold=args.adaptive_threshold,
            cfg_skip_threshold=args.cfg_skip_threshold,
            segment_steps=args.segment_steps,
            callback_on_segment_end=progress,
            progress=args.progress,
        )
    dt = time.perf_counter() - t1
    if profiler is not None:
        profiler.stop()
        os.makedirs(args.profile_dir, exist_ok=True)
        profiler.export_chrome_trace(os.path.join(args.profile_dir, "trace.json"))
    say(f"[s2v_torch] generated {video.shape} in {dt:.1f}s "
        f"({args.num_inference_steps / dt:.2f} steps/s incl. VAE)")
    say(f"[s2v_torch] stage seconds {json.dumps(pipe.timings)}")
    if profiler is not None:
        from s2v_torch.utils.logging import span_summary

        # {name: [calls, host_ms, device_ms, self_device_ms]}, device values null on the CPU
        say(f"[s2v_torch] spans {json.dumps(span_summary())}")
    if not main_rank:
        return
    out_path = os.path.join(args.output_dir, "output.mp4")
    written = export_to_video(to_uint8_frames(video[0]), out_path, fps=args.fps)
    say(f"[s2v_torch] wrote {written}")
    say("Inference completed", flush=True)


if __name__ == "__main__":
    main()
