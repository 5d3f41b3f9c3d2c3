"""Fine-tuning CLI of the port, flag for flag the JAX package's
(``s2v_tpu/train.py``): LoRA adapters on the frozen DiT (QLoRA over an int8
base with ``--quantize_base``), or every transformer parameter
(``--train_mode full``, fp32 master weights, an optional EMA), on one CUDA
card or across cards:

    python -m s2v_torch.train \\
        --pretrained_model_name_or_path /path/to/CogVideoX-5b-snapshot \\
        --dataset_dir /path/to/videos --output_dir ./lora_out \\
        --rank 128 --lora_alpha 64 --max_train_steps 1000

The dataset is a folder of clips with an optional ``prompts.txt`` and
``<stem>_ref.png`` subject images (``training/data.py::VideoFolderDataset``).
LoRA mode writes the adapters in the reference's diffusers key format to
``<output_dir>/pytorch_lora_weights_transformer.safetensors`` (what
``from_pretrained(lora_checkpoint=...)`` and the reference load) and the
resumable state to ``<output_dir>/train_state_<step>/``
(``loaders/train_state.py``: adapters or params, optimizer state, step);
full mode writes the state and, at the end, ``<output_dir>/snapshot/``
(``save_pretrained``, the EMA weights when there is an EMA).  Validation
clips go to ``<output_dir>/samples/step<k>_p<i>_v<j>.mp4``.

Where the port differs from the JAX CLI, by design:

* every batch carries the positions the model samples with: the RoPE tables
  of a RoPE model, the sincos table of a 2b model, built as ``generate``
  builds them.  JAX's batches carry none, so its CLI trains without
  positions (ROADMAP C.3, C.19);
* ``--compute_dtype auto`` is bf16 on the card and none on the CPU (JAX:
  bf16 on its accelerator, the TPU);
* the random draws of micro-step ``m`` (timesteps, noise) come from a
  ``torch.Generator`` seeded with ``seed·2³² + m`` on the card (JAX folds
  ``m`` into its key), so a resumed run draws what the uninterrupted run
  drew;
* ``--device`` (default ``cuda``; ``cpu`` for the tests) and ``--dtype``
  (the model's, default ``bfloat16``; ``float16`` for the 2b family) are
  the port's own flags; ``--attention_backend`` takes the JAX names
  (``auto`` is the flash kernels on CUDA and the plain attention on the
  CPU, ``pallas`` is ``flash``, ``xla`` is ``plain``), and
  ``--compilation_cache_dir`` is accepted and ignored.

Across cards: ``torchrun --nproc_per_node N -m s2v_torch.train --mesh
dp<a>,tp<b>,sp<c> ...`` (a·b·c = N, one process per card; a one-rank mesh
runs without ``torchrun``), as JAX's ``--mesh`` (``:218-290, 484-525``):

* ``data`` splits every batch (``--train_batch_size`` must divide over it);
  in full mode it also shards the params, gradients, optimizer state and
  EMA (FSDP, ``training/full.py``), and in LoRA mode with ``--fsdp_base``
  (``data`` ≥ 2, no ``model`` above 1) the frozen base;
* ``model`` runs megatron TP on the sliced base (LoRA) or params (full);
* ``seq`` shards the video frames; ``pallas`` becomes ``sp_allgather`` and
  ``windowed`` ``sp_windowed`` on a ring above 1, as in JAX.

Every rank loads and encodes the same batches and draws the same noise;
rank 0 alone logs, writes the adapters, the snapshot and the validation
clips.  The train state is written sharded (``loaders/train_state.py``: one
file per rank) and resumes on a mesh of the same sizes only.  Validation in
full mode gathers the master weights (or the EMA) into a whole copy in the
model's dtype and samples on one card's path (JAX's ``_val_params``).
"""

from __future__ import annotations

import argparse
import os
import re
import time
from dataclasses import replace

from s2v_torch.cli_utils import BACKEND_NAMES, SEQ_BACKEND_NAMES

# the JAX trainer's --attention_backend choices (s2v_tpu/train.py:80-83)
TRAIN_BACKEND_CHOICES = ["auto", "xla", "chunked", "pallas", "ring", "sp_allgather", "sp_ulysses", "sp_windowed",
                         "windowed"]
LORA_FILE = "pytorch_lora_weights_transformer.safetensors"


def get_args(argv=None):
    p = argparse.ArgumentParser(description="Disentangled subject-to-video fine-tuning (PyTorch/CUDA)")
    p.add_argument("--pretrained_model_name_or_path", type=str, required=True)
    p.add_argument("--dataset_dir", type=str, required=True,
                   help="folder of videos (+ optional prompts.txt / <stem>_ref.png)")
    p.add_argument("--output_dir", type=str, default="lora_out")
    p.add_argument("--train_mode", type=str, default="lora", choices=["lora", "full"],
                   help="lora = adapters on the 9 reference target families; full = every transformer param, "
                        "fp32 master weights (FSDP over --mesh's data dim)")
    p.add_argument("--compute_dtype", type=str, default="auto", choices=["auto", "none", "bfloat16"],
                   help="full mode forward-pass dtype (master weights stay fp32); auto = bfloat16 on the card, "
                        "none on the CPU; none on the card runs the fp32 attention kernels (B1/B2, B4-B7 as 3xTF32)")
    p.add_argument("--ema_decay", type=float, default=0.0,
                   help="full mode: keep an EMA of the params at this decay (e.g. 0.9999); the final snapshot "
                        "exports the EMA weights. 0 = off")
    p.add_argument("--rank", type=int, default=128)
    p.add_argument("--lora_alpha", type=float, default=64)
    p.add_argument("--learning_rate", type=float, default=1e-4)
    p.add_argument("--optimizer", type=str, default="adamw", choices=["adamw", "adam", "prodigy"],
                   help="reference-template optimizer choice (prodigy wants learning_rate near 1.0)")
    p.add_argument("--lr_scheduler", type=str, default="constant",
                   choices=["constant", "constant_with_warmup", "linear", "cosine"])
    p.add_argument("--lr_warmup_steps", type=int, default=0)
    p.add_argument("--max_grad_norm", type=float, default=1.0,
                   help="global grad-norm clip (template default 1.0; <=0 disables)")
    p.add_argument("--gradient_accumulation_steps", type=int, default=1)
    p.add_argument("--adam_beta1", type=float, default=0.9)
    p.add_argument("--adam_beta2", type=float, default=0.95)
    p.add_argument("--adam_weight_decay", type=float, default=1e-4)
    p.add_argument("--adam_epsilon", type=float, default=1e-8)
    p.add_argument("--moment_dtype", type=str, default="float32", choices=["float32", "bfloat16"],
                   help="adam/adamw first-moment (mu) storage dtype")
    p.add_argument("--train_batch_size", type=int, default=1)
    p.add_argument("--max_train_steps", type=int, default=1000)
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--width", type=int, default=720)
    p.add_argument("--max_num_frames", type=int, default=49)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--checkpointing_steps", type=int, default=500)
    p.add_argument("--encode_cache_dir", type=str, default=None,
                   help="persist per-clip VAE moments + T5 embeds to disk (npz keyed on the files): restarted "
                        "runs skip the encode pass; posterior noise stays fresh per epoch")
    p.add_argument("--attention_backend", type=str, default="auto", choices=TRAIN_BACKEND_CHOICES,
                   help="auto = the flash kernels on CUDA, plain attention on the CPU; pallas = flash kernels "
                        "both ways; windowed = banded sliding-window kernels both ways; ring and sp_* need --mesh")
    p.add_argument("--remat", type=str, default="full",
                   help="block rematerialization: full = recompute each block in the backward, dots = save the "
                        "linears' outputs and recompute the rest, seg / seg<N> = nested checkpoints over N "
                        "segments, none = no remat")
    p.add_argument("--attention_window", type=int, default=2,
                   help="half-width (latent frames) for --attention_backend windowed")
    p.add_argument("--disentangled_modulation", action="store_true", default=False,
                   help="train norm1/norm2 LoRA with the intended enable_lora semantics (ref-stream-only "
                        "modulation adapters)")
    p.add_argument("--quantize_base", action="store_true", default=False,
                   help="QLoRA: freeze the base transformer in int8 and apply adapters output-additively "
                        "(lora mode only)")
    p.add_argument("--validation_prompt", type=str, default=None,
                   help="prompt(s) sampled during training; separate several with --validation_prompt_separator")
    p.add_argument("--validation_prompt_separator", type=str, default=":::")
    p.add_argument("--validation_ref_img", type=str, default=None,
                   help="subject image for validation (defaults to the first dataset clip's ref frame)")
    p.add_argument("--validation_steps", type=int, default=0,
                   help="run validation sampling every N optimizer steps (0 = off)")
    p.add_argument("--num_validation_videos", type=int, default=1)
    p.add_argument("--validation_num_inference_steps", type=int, default=20)
    p.add_argument("--resume_from_checkpoint", type=str, default=None,
                   help="train-state dir written by --checkpointing_steps (adapters or params + optimizer state "
                        "+ step)")
    p.add_argument("--mesh", type=str, default=None,
                   help="mesh over the processes torchrun started, one per card, e.g. dp4 or dp2,tp2 (data: the "
                        "batch and FSDP, model: megatron TP, seq: video frames)")
    p.add_argument("--fsdp_base", action="store_true", default=False,
                   help="LoRA: shard the frozen base 1/N over the mesh's data dim (needs data >= 2, no model dim "
                        "above 1)")
    p.add_argument("--compilation_cache_dir", type=str, default="auto",
                   help="accepted for the JAX CLI's command lines and ignored: the port compiles no XLA programs")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    p.add_argument("--dtype", type=str, default="bfloat16", choices=["bfloat16", "float16", "float32"],
                   help="the model's dtype (the 2b family publishes float16); float32 on the card runs the fp32 "
                        "attention kernels (B1/B2, B4-B7 as 3xTF32)")
    return p.parse_args(argv)


_REMAT_MODES = {"full": True, "dots": "dots", "none": False}


def _remat_mode(name: str):
    """full/dots/none/seg/seg<N> -> ``transformer_forward``'s remat setting."""
    if name in _REMAT_MODES:
        return _REMAT_MODES[name]
    if re.fullmatch(r"seg\d*", name):
        return name
    raise SystemExit(f"--remat {name!r}: expected full, dots, none, seg or segN")


def _resume_position(args, step, dataset):
    """(micro, epoch, skip_batches) of an optimizer-step count: a resumed run
    continues the shuffled data order where it stopped, the same epoch seed
    and the offset inside the epoch (``s2v_tpu/train.py:152-159``)."""
    micro = step * args.gradient_accumulation_steps
    bpe = max(1, len(dataset) // args.train_batch_size)
    return micro, micro // bpe, micro % bpe


_RESUME_MISMATCH = (
    "cannot restore {path}: the train-state tree must match the flags that "
    "wrote it — optimizer / lr_scheduler / max_grad_norm / "
    "gradient_accumulation_steps / ema_decay shape the optimizer state, "
    "and a sharded state written under a different --mesh cannot be "
    "restored without that mesh (checkpoints from before the "
    "optimizer-surface upgrade use a plain adamw layout).  "
    "Original error: {err}"
)


def check_mesh_args(args) -> dict:
    """The ``--mesh`` dim sizes (empty without one), after JAX's refusals:
    the batch must split over ``data``, ``--fsdp_base`` needs ``data`` ≥ 2
    and no ``model`` dim above 1 (``s2v_tpu/train.py:250-254, 505-509``);
    and, as the port adds, a sequence-parallel backend needs a mesh and
    ``--fsdp_base`` a LoRA run on one (JAX ignores it there)."""
    from s2v_torch.parallel.sharding import parse_mesh_spec
    from s2v_torch.training.data import data_rows

    sizes = parse_mesh_spec(args.mesh) if args.mesh is not None else {}
    if args.attention_backend in SEQ_BACKEND_NAMES and not sizes:
        raise SystemExit(f"--attention_backend {args.attention_backend} needs --mesh (sp1 on one card)")
    if "data" in sizes:
        try:
            data_rows(args.train_batch_size, sizes["data"])
        except ValueError as e:
            raise SystemExit(str(e)) from e
    if args.fsdp_base:
        if args.train_mode != "lora":
            raise SystemExit("--fsdp_base is a LoRA-mode option (full mode shards every parameter over data)")
        if sizes.get("model", 1) > 1:
            raise SystemExit("--fsdp_base conflicts with a TP 'model' axis (base params are already sharded)")
        if sizes.get("data", 1) < 2:
            raise SystemExit("--fsdp_base needs a data mesh axis >= 2")
    return sizes


def _reroute_for_seq(args, sizes: dict) -> None:
    """On a ring above 1 the flash kernels become ``sp_allgather`` and the
    banded ones ``sp_windowed``, as JAX reroutes (``s2v_tpu/train.py:240-245``)."""
    if sizes.get("seq", 1) > 1:
        args.attention_backend = {"flash": "sp_allgather", "windowed": "sp_windowed"}.get(args.attention_backend,
                                                                                          args.attention_backend)


def _micro_generator(args, micro: int, device):
    """The draws of micro-step ``micro`` (timesteps, then noise), from its own seed."""
    import torch

    return torch.Generator(device=device).manual_seed((args.seed * 2 ** 32 + micro) % 2 ** 63)


def _add_positions(batch: dict, pipe, args) -> dict:
    """The positions the model samples with (ROADMAP C.3, C.19): RoPE tables
    for a RoPE model, the sincos table for a 2b model."""
    f_lat = batch["video_latents"].shape[1]
    cos, sin = pipe.prepare_rope(args.height, args.width, f_lat)
    if cos is not None:
        batch["rope_cos"], batch["rope_sin"] = cos, sin
    table = pipe.prepare_pos_embedding(args.height, args.width, args.max_num_frames)
    if table is not None:
        batch["pos_embedding"] = table
    return batch


def _batches(args, pipe, dataset, epoch, cache):
    from s2v_torch.training.data import latent_batches, prefetch_batches

    for batch in prefetch_batches(latent_batches(dataset, pipe, args.train_batch_size, seed=args.seed + epoch,
                                                 cache=cache, cache_dir=args.encode_cache_dir)):
        yield _add_positions(batch, pipe, args)


def _validate(args, pipe, dataset, step, log, params_override=None, cfg_override=None, write=True):
    """Validation sampling (the reference template's ``log_validation``):
    ``--num_validation_videos`` clips per validation prompt with the current
    weights, written under ``output_dir/samples/``.  The pipeline's weights
    and config are swapped for the call and restored after.  On a mesh
    every rank samples (the generate is collective) and the rank with
    ``write`` writes."""
    from s2v_torch.utils.video import export_to_video, to_uint8_frames

    if not args.validation_prompt:
        return
    outdir = os.path.join(args.output_dir, "samples")
    if write:
        os.makedirs(outdir, exist_ok=True)
    ref = args.validation_ref_img
    if ref is None:
        ref = dataset[0]["ref_image"]  # [H, W, 3] in [-1, 1]
    prev_params, prev_cfg = pipe.transformer_params, pipe.transformer_cfg
    if params_override is not None:
        pipe.transformer_params = params_override
    if cfg_override is not None:
        pipe.transformer_cfg = cfg_override
    try:
        prompts = [p.strip() for p in args.validation_prompt.split(args.validation_prompt_separator) if p.strip()]
        for pi, prompt in enumerate(prompts):
            for vi in range(args.num_validation_videos):
                frames = pipe.generate(prompt=prompt, ref_image=ref, height=args.height, width=args.width,
                                       num_frames=args.max_num_frames,
                                       num_inference_steps=args.validation_num_inference_steps,
                                       seed=args.seed + vi, output_type="np")
                clip = frames[0] if frames.ndim == 5 else frames
                path = os.path.join(outdir, f"step{step}_p{pi}_v{vi}.mp4")
                if write:
                    export_to_video(to_uint8_frames(clip), path, fps=8)
                    log.info("validation step %d: %s", step, path)
    finally:
        pipe.transformer_params, pipe.transformer_cfg = prev_params, prev_cfg


def _mesh_ctx(mesh):
    """The context a train step runs under: the mesh's, or none."""
    from contextlib import nullcontext

    from s2v_torch.parallel.context import default_logical_map, mesh_context

    return nullcontext() if mesh is None else mesh_context(mesh, default_logical_map(mesh))


def _compute_dtype(args, device):
    import torch

    if args.compute_dtype == "bfloat16" or (args.compute_dtype == "auto" and device.type == "cuda"):
        return torch.bfloat16
    return None


def _restore(args, target, mesh=None):
    """The train state at ``--resume_from_checkpoint`` in ``target``'s tree
    (this rank's shards on a mesh), or SystemExit with JAX's
    resume-mismatch text."""
    from s2v_torch.loaders.train_state import load_train_state

    path = os.path.abspath(os.path.expanduser(args.resume_from_checkpoint))
    try:
        return load_train_state(path, target, mesh=mesh)
    except (ValueError, OSError, KeyError) as e:
        raise SystemExit(_RESUME_MISMATCH.format(path=args.resume_from_checkpoint, err=e)) from e


def _run_full(args, pipe, dataset, opt_spec, log, mesh=None, main=True):
    """Full-parameter fine-tuning: fp32 master weights (with a bf16 forward
    under ``--compute_dtype``), an optional EMA, a resumable train state,
    and the final weights (the EMA when kept) exported as an HF-layout
    snapshot.  On a mesh with a ``data`` or ``model`` dim the state is
    sharded (FSDP, megatron TP; ``training/full.py``) and the whole tree
    never reaches one card: the pipeline's inference copy moves to the
    host, and each rank casts and places its shards from there."""
    import torch

    from s2v_torch.loaders.train_state import save_train_state
    from s2v_torch.parallel.sharding import gather_params, mesh_sizes
    from s2v_torch.pipelines.s2v import _to
    from s2v_torch.training.full import cast_floating, make_full_train_step, state_placements

    sharded = bool({"data", "model"} & set(mesh_sizes(mesh)))
    prepare, init_opt, train_step = make_full_train_step(
        pipe.transformer_cfg, pipe.scheduler_cfg, opt_spec, attention_backend=args.attention_backend,
        compute_dtype=_compute_dtype(args, pipe.device), ema_decay=args.ema_decay, remat=_remat_mode(args.remat),
        mesh=mesh if sharded else None)
    if sharded:
        pipe.transformer_params = _to(pipe.transformer_params, torch.device("cpu"))
    params = prepare(pipe.transformer_params, dtype=torch.float32)
    opt_state = init_opt(params)
    placements = state_placements(prepare.specs, args.ema_decay > 0) if sharded else None

    def sample_tree(dtype=None):
        """The weights to sample from, the EMA when kept; whole (gathered
        from every rank's shards) on a sharded mesh, cast to ``dtype``."""
        tree = opt_state[1] if args.ema_decay > 0 else params
        if not sharded:
            return tree if dtype is None else cast_floating(tree, dtype)
        return gather_params(tree, mesh, prepare.specs, dtype=dtype)

    def save(step, final=False):
        state_dir = os.path.join(os.path.abspath(args.output_dir), f"train_state_{step}")
        save_train_state({"params": params, "opt_state": opt_state, "step": step}, state_dir,
                         mesh=mesh if sharded else None, placements=placements)
        log.info("step %d: saved %s", step, state_dir)
        if final:
            pipe.transformer_params = sample_tree()
            out = pipe.save_pretrained(os.path.join(args.output_dir, "snapshot"), dtype="bfloat16", write=main)
            log.info("exported fine-tuned pipeline snapshot: %s", out)

    step = micro = epoch = skip_batches = 0
    if args.resume_from_checkpoint:
        state = _restore(args, {"params": params, "opt_state": opt_state, "step": 0}, mesh if sharded else None)
        params, opt_state, step = state["params"], state["opt_state"], state["step"]
        micro, epoch, skip_batches = _resume_position(args, step, dataset)
        log.info("resumed from %s at step %d (epoch %d, +%d batches)", args.resume_from_checkpoint, step, epoch,
                 skip_batches)

    t0 = time.perf_counter()
    start_step = step
    encode_cache: dict = {}
    while step < args.max_train_steps:
        for batch in _batches(args, pipe, dataset, epoch, encode_cache):
            if skip_batches:
                skip_batches -= 1
                continue
            with _mesh_ctx(mesh):
                params, opt_state, loss = train_step(params, opt_state, batch,
                                                     _micro_generator(args, micro, pipe.device))
            micro += 1
            if micro % args.gradient_accumulation_steps:
                continue
            step += 1
            if step % 10 == 0 or step == start_step + 1:
                log.info("step %d/%d loss %.4f (%.2f s/step)", step, args.max_train_steps, float(loss),
                         (time.perf_counter() - t0) / (step - start_step))
            if args.validation_steps and step % args.validation_steps == 0:
                whole = sample_tree(pipe.transformer_cfg.dtype)  # every rank gathers
                if main:  # the whole copy samples on one card's path
                    _validate(args, pipe, dataset, step, log, params_override=whole)
                del whole
            if step % args.checkpointing_steps == 0 or step >= args.max_train_steps:
                save(step, final=step >= args.max_train_steps)
            if step >= args.max_train_steps:
                break
        epoch += 1
    log.info("full fine-tuning complete")


def main(args=None):
    args = args if isinstance(args, argparse.Namespace) else get_args(args)
    sizes = check_mesh_args(args)
    os.makedirs(args.output_dir, exist_ok=True)

    from s2v_torch.parallel.sharding import entry_point_mesh
    from s2v_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    with entry_point_mesh(args.mesh, device.type) as mesh:
        return _train(args, device, mesh, sizes)


def _train(args, device, mesh, sizes):
    """The run of :func:`main` on ``device`` (and ``mesh``, None without one)."""
    import logging

    import torch

    from s2v_torch.loaders.safetensors_io import save_safetensors
    from s2v_torch.loaders.train_state import save_train_state
    from s2v_torch.pipelines.s2v import S2VPipeline
    from s2v_torch.training.data import VideoFolderDataset
    from s2v_torch.training.lora import (
        LoRASpec,
        _runtime_tree,
        export_lora_to_reference_format,
        init_lora_params,
        make_lora_train_step,
        merge_lora_params,
    )
    from s2v_torch.parallel.multihost import is_main_process
    from s2v_torch.parallel.sharding import fsdp_param_specs, gather_params, shard_params
    from s2v_torch.training.optim import OptimizerSpec
    from s2v_torch.utils.logging import get_logger

    log = get_logger("s2v_torch.train")
    main_rank = is_main_process()
    if not main_rank:
        log.setLevel(logging.WARNING)  # rank 0 alone logs
    args.attention_backend = BACKEND_NAMES[args.attention_backend]
    if not (0.0 <= args.ema_decay < 1.0):
        raise SystemExit(f"--ema_decay {args.ema_decay} must be in [0, 1): 1.0 would freeze the EMA at the initial "
                         f"weights (and the final snapshot would export an untrained model)")
    if args.quantize_base and args.train_mode != "lora":
        raise SystemExit("--quantize_base is a LoRA-mode option (full fine-tuning updates the base weights, which "
                         "must stay bf16/fp32)")
    if args.quantize_base and args.disentangled_modulation:
        raise SystemExit("--quantize_base cannot combine with --disentangled_modulation (the disentangled path "
                         "merges modulation kernels into the base tree)")
    pipe = S2VPipeline.from_pretrained(os.path.expanduser(args.pretrained_model_name_or_path),
                                       quantize_int8=args.quantize_base, dtype=getattr(torch, args.dtype),
                                       device=device)
    pipe.set_attention(args.attention_backend, args.attention_window)
    args.attention_backend = pipe.attention_backend  # auto, resolved on the device
    _reroute_for_seq(args, sizes)
    tc = pipe.vae_cfg.temporal_compression_ratio
    if (args.max_num_frames - 1) % tc:
        # the template trims clips so (F - 1) divides the VAE's temporal
        # compression; the requested count is validated instead of dropping frames
        raise SystemExit(f"--max_num_frames {args.max_num_frames} must satisfy (F - 1) % {tc} == 0 "
                         f"(e.g. {((args.max_num_frames - 1) // tc) * tc + 1})")
    dataset = VideoFolderDataset(args.dataset_dir, num_frames=args.max_num_frames, height=args.height,
                                 width=args.width)
    log.info("dataset: %d clips", len(dataset))

    opt_spec = OptimizerSpec(
        optimizer=args.optimizer, learning_rate=args.learning_rate, lr_scheduler=args.lr_scheduler,
        lr_warmup_steps=args.lr_warmup_steps, max_train_steps=args.max_train_steps,
        max_grad_norm=args.max_grad_norm if args.max_grad_norm > 0 else None,
        weight_decay=args.adam_weight_decay, beta1=args.adam_beta1, beta2=args.adam_beta2,
        epsilon=args.adam_epsilon, gradient_accumulation_steps=args.gradient_accumulation_steps,
        moment_dtype=args.moment_dtype,
    )
    if args.train_mode == "full":
        return _run_full(args, pipe, dataset, opt_spec, log, mesh, main_rank)

    spec = LoRASpec(rank=args.rank, alpha=args.lora_alpha, disentangled=args.disentangled_modulation)
    # the adapters' shapes come from the whole base, before any slicing
    lora = init_lora_params(torch.Generator(device=device).manual_seed(args.seed), pipe.transformer_params, spec)
    base_specs = None
    if mesh is not None and args.fsdp_base:
        # the frozen base 1/N over data, placed once (s2v_tpu/train.py:510-522)
        pipe.set_mesh(mesh, shard_now=False)
        base_specs = fsdp_param_specs(pipe.transformer_params, sizes["data"])
        pipe.transformer_params = shard_params(pipe.transformer_params, mesh, base_specs)
    elif mesh is not None:
        pipe.set_mesh(mesh)  # slices the base over a model dim
    init_opt, train_step = make_lora_train_step(
        pipe.transformer_params, pipe.transformer_cfg, spec, pipe.scheduler_cfg,
        attention_backend=args.attention_backend, optimizer_spec=opt_spec, remat=_remat_mode(args.remat),
        base_specs=base_specs)
    opt_state = init_opt(lora)

    def save(step):
        # the reference-format adapters (what inference loads), then the resumable state
        path = os.path.join(args.output_dir, LORA_FILE)
        if main_rank:
            save_safetensors(export_lora_to_reference_format(lora, spec, pipe.transformer_cfg), path)
        state_dir = os.path.join(os.path.abspath(args.output_dir), f"train_state_{step}")
        save_train_state({"lora": lora, "opt_state": opt_state, "step": step}, state_dir, mesh=mesh)
        log.info("step %d: saved %s (+ %s)", step, path, state_dir)

    def validation_override():
        """The weights and config to sample with: the merged tree, or on an
        int8 base the runtime factor tree (what the QLoRA loss trains); the
        disentangled config when it is trained."""
        from s2v_torch.models.transformer import RUNTIME_LORA_KEY

        cfg_ov = replace(pipe.transformer_cfg, disentangled_modulation=True) if spec.disentangled else None
        base = pipe.transformer_params
        with torch.no_grad(), pipe._mesh_ctx():  # a model dim's merge slices the deltas
            if base_specs is not None:
                base = gather_params(base, mesh, base_specs)  # whole for the sampling
            if args.quantize_base:
                ov = dict(base)
                ov[RUNTIME_LORA_KEY] = _runtime_tree(lora, spec, pipe.transformer_cfg.dtype)
            else:
                ov = merge_lora_params(base, lora, spec)
        return ov, cfg_ov

    step = micro = epoch = skip_batches = 0
    if args.resume_from_checkpoint:
        state = _restore(args, {"lora": lora, "opt_state": opt_state, "step": 0}, mesh)
        lora, opt_state, step = state["lora"], state["opt_state"], state["step"]
        micro, epoch, skip_batches = _resume_position(args, step, dataset)
        log.info("resumed from %s at step %d (epoch %d, +%d batches)", args.resume_from_checkpoint, step, epoch,
                 skip_batches)
    t0 = time.perf_counter()
    start_step = step
    # clips are encoded once (VAE moments + T5 embeds cached on the host; the
    # posterior noise stays per-epoch); the batches are prepared on a
    # background thread beside the train step
    encode_cache: dict = {}
    while step < args.max_train_steps:
        for batch in _batches(args, pipe, dataset, epoch, encode_cache):
            if skip_batches:
                skip_batches -= 1
                continue
            with pipe._mesh_ctx():
                lora, opt_state, loss = train_step(lora, opt_state, batch, _micro_generator(args, micro, device))
            micro += 1
            if micro % args.gradient_accumulation_steps:
                continue  # the optimizer update lands on the k-th micro-step
            step += 1
            if step % 10 == 0 or step == start_step + 1:
                log.info("step %d/%d loss %.4f (%.2f s/step)", step, args.max_train_steps, float(loss),
                         (time.perf_counter() - t0) / (step - start_step))
            if args.validation_steps and step % args.validation_steps == 0:
                ov, cfg_ov = validation_override()
                _validate(args, pipe, dataset, step, log, params_override=ov, cfg_override=cfg_ov, write=main_rank)
                del ov
            if step % args.checkpointing_steps == 0 or step >= args.max_train_steps:
                save(step)
            if step >= args.max_train_steps:
                break
        epoch += 1
    if step % args.checkpointing_steps != 0 and step < args.max_train_steps:
        save(step)  # the loop saved on checkpoint boundaries and at the end
    log.info("training complete")


if __name__ == "__main__":
    main()
