"""The port's multi-rank dry run: the sharded product paths on N gloo ranks on
the CPU (counterpart of ``__graft_entry__.py::dryrun_multichip`` and its
phases, ``_dryrun_impl`` and ``_dryrun_n16_impl``).

    python -m s2v_torch.dryrun --ranks 8

spawns N processes, one rank each, in one gloo group over a ``FileStore``
(no network), and runs on the tiny config (``s2v_torch/testing.py``):

  1. ``generate`` under a ``data`` x ``model`` mesh (the DiT sliced for
     megatron TP, the batched CFG's rows over ``data``);
  2. ``generate`` on a ``seq`` ring of N (frame shards, the context-parallel
     VAE decode of N latent frames);
  3. ``generate`` with ``sp_ulysses`` (all-to-all from frames to heads);
  4. ``generate`` with ``sp_windowed`` (B6's plain version on each shard);
  5. a runtime LoRA attached under the ``data`` x ``model`` mesh, then
     detached, through ``generate``;
  6. the LoRA train step under ``data`` x ``model``;
  7. the FSDP full fine-tune step over ``data`` of N (params, gradients and
     optimizer state sharded 1/N);
  8. the QLoRA train step (an int8 base sliced over ``model``);
  9. with N >= 16 (a multiple of 8): ``data`` x ``seq`` 8 with
     ``sp_ulysses`` on 8 heads, and ``data`` x ``seq`` 4 x ``model`` 2 on 6
     heads, where ``sp_ulysses`` falls back to ``sp_allgather``.

Rank 0 prints one line a phase, ``dryrun: [i/n] <phase> OK (<s> s)``; a rank
whose phase fails prints the error and the run exits non-zero.  Every output
is checked finite.  The CPU tests run it at 4 ranks
(``tests/test_torch_dryrun.py``).
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time
import traceback
from datetime import timedelta

import torch
import torch.distributed as dist

# how long a collective may wait before the group fails it (a rank that
# died leaves the others waiting)
COLLECTIVE_TIMEOUT_S = 120


def _finite(x) -> None:
    t = torch.as_tensor(x)
    if not bool(torch.isfinite(t.float()).all()):
        raise AssertionError("non-finite output")


def _dp_tp(n: int) -> dict:
    """The data x model mesh of phases 1, 5, 6 and 8: the widest model dim
    of 4, 2 or 1 (the tiny DiT's 4 heads) that leaves at least 2 data ranks."""
    if n == 1:
        return {"model": 1}
    model = max(d for d in (4, 2, 1) if n % d == 0 and n // d >= 2)
    return {"data": n // model, "model": model}


def _mesh(sizes: dict):
    from s2v_torch.parallel.sharding import make_mesh

    return make_mesh(sizes, "cpu")


def _whole_params(cfg):
    from s2v_torch.models.transformer import init_transformer_params_random

    return init_transformer_params_random(cfg, seed=0, device="cpu")


def _batch(cfg, rows: int, frames: int = 2, size: int = 8) -> dict:
    """A seeded train batch: ``rows`` clips of ``frames`` latent frames of
    ``size`` x ``size``, with the RoPE tables of that geometry."""
    from s2v_torch.testing import tiny_pipeline

    gen = torch.Generator().manual_seed(1)
    c = cfg.in_channels
    batch = {"video_latents": torch.randn(rows, frames, size, size, c, generator=gen),
             "ref_latents": torch.randn(rows, 1, size, size, c, generator=gen),
             "text_embeds": torch.randn(rows, cfg.max_text_seq_length, cfg.text_embed_dim, generator=gen)}
    pipe = tiny_pipeline(device="cpu")
    sc = pipe.vae_cfg.spatial_compression_ratio
    batch["rope_cos"], batch["rope_sin"] = pipe.prepare_rope(size * sc, size * sc, frames)
    return batch


def _phases(n: int):
    """(name, function) of every phase for a world of n ranks."""
    from s2v_torch.config import TransformerConfig
    from s2v_torch.ops.attention import route_seq_backend
    from s2v_torch.parallel import default_logical_map, mesh_context
    from s2v_torch.testing import tiny_generate_kwargs, tiny_pipeline

    state = {}
    dp_tp = _dp_tp(n)
    cfg = TransformerConfig.tiny()
    spec_kw = dict(rank=2, alpha=4.0)

    def generate_dp_tp():
        pipe = tiny_pipeline(device="cpu")
        kw = tiny_generate_kwargs(pipe, num_inference_steps=1, output_type="latent")
        pipe.set_mesh(dp_tp)
        out = pipe.generate(**kw)
        _finite(out)
        state.update(pipe=pipe, kw=kw, out=out)

    def generate_seq():
        pipe = tiny_pipeline(device="cpu")
        tc = pipe.vae_cfg.temporal_compression_ratio
        pipe.set_mesh({"seq": n})
        # (n - 1)·tc + 1 frames: n latent frames, decoded context-parallel
        _finite(pipe.generate(**dict(state["kw"], num_frames=(n - 1) * tc + 1, output_type="np")))

    # Ulysses needs heads % seq == 0 (the tiny DiT's 4 heads)
    sp = max(d for d in (1, 2, 4) if cfg.num_attention_heads % d == 0 and n % d == 0)
    ulysses_mesh = {"data": n // sp, "seq": sp} if n > sp else {"seq": sp}

    def generate_ulysses():
        pipe = tiny_pipeline("sp_ulysses", device="cpu")
        pipe.set_mesh(ulysses_mesh)
        _finite(pipe.generate(**state["kw"]))

    def generate_sp_windowed():
        pipe = tiny_pipeline(device="cpu")
        pipe.set_attention("sp_windowed", 1)
        pipe.set_mesh({"seq": n})
        tc = pipe.vae_cfg.temporal_compression_ratio
        _finite(pipe.generate(**dict(state["kw"], num_frames=(n - 1) * tc + 1)))

    def runtime_lora():
        from s2v_torch.training.lora import LoRASpec, init_lora_params, runtime_tree_from_training

        spec = LoRASpec(**spec_kw)
        lora = init_lora_params(torch.Generator().manual_seed(5), _whole_params(cfg), spec)
        gen = torch.Generator().manual_seed(6)
        lora = {k: {n_: t + 0.05 * torch.randn(t.shape, generator=gen) for n_, t in ab.items()}
                for k, ab in lora.items()}
        pipe = state["pipe"]
        tree = runtime_tree_from_training(lora, spec)  # numpy, as the JAX package's
        pipe.set_runtime_lora({part: {name: {k: torch.from_numpy(v) for k, v in ab.items()}
                                      for name, ab in targets.items()} for part, targets in tree.items()})
        out = pipe.generate(**state["kw"])
        _finite(out)
        if not float((out - state["out"]).abs().max()) > 0:
            raise AssertionError("the runtime adapter did not change the output")
        pipe.set_runtime_lora(None)

    def _lora_step(base, mesh):
        from s2v_torch.training.lora import LoRASpec, init_lora_params, make_lora_train_step

        spec = LoRASpec(**spec_kw)
        lora = init_lora_params(torch.Generator().manual_seed(2), _whole_params(cfg), spec)
        init, step = make_lora_train_step(base, cfg, spec, attention_backend="plain", learning_rate=1e-3)
        rows = dp_tp.get("data", 1)
        with mesh_context(mesh, default_logical_map(mesh)):
            _, _, loss = step(lora, init(lora), _batch(cfg, rows), torch.Generator().manual_seed(3))
        _finite(loss)

    def lora_step():
        from s2v_torch.parallel.sharding import shard_params, transformer_param_specs_like

        mesh = _mesh(dp_tp)
        base = _whole_params(cfg)
        _lora_step(shard_params(base, mesh, transformer_param_specs_like(base)), mesh)

    def fsdp_step():
        from s2v_torch.training.full import make_full_train_step
        from s2v_torch.training.optim import OptimizerSpec

        mesh = _mesh({"data": n})
        prep, init, step = make_full_train_step(cfg, optimizer_spec=OptimizerSpec(learning_rate=1e-3),
                                                attention_backend="plain", mesh=mesh, fsdp_min_size=64)
        params = prep(_whole_params(cfg), dtype=torch.float32)
        params, _, loss = step(params, init(params), _batch(cfg, n), torch.Generator().manual_seed(4))
        _finite(loss)
        qkv = params["blocks"][0]["attn"]["qkv"]["weight"]
        if qkv.numel() * n != 3 * cfg.inner_dim * cfg.inner_dim:
            raise AssertionError(f"the FSDP params must stay sharded 1/{n}: qkv holds {qkv.numel()} elements")

    def qlora_step():
        from s2v_torch.ops.quant import quantize_transformer_params
        from s2v_torch.parallel.sharding import shard_params, transformer_param_specs_like

        mesh = _mesh(dp_tp)
        base = quantize_transformer_params(_whole_params(cfg))
        _lora_step(shard_params(base, mesh, transformer_param_specs_like(base)), mesh)

    def sixteen():
        pipe = tiny_pipeline("sp_ulysses", device="cpu", num_attention_heads=8)
        tc = pipe.vae_cfg.temporal_compression_ratio
        pipe.set_mesh({"data": n // 8, "seq": 8})
        kw = tiny_generate_kwargs(pipe, num_inference_steps=1, output_type="latent", num_frames=7 * tc + 1)
        _finite(pipe.generate(**kw))
        pipe = tiny_pipeline("sp_ulysses", device="cpu", num_attention_heads=6)
        pipe.set_mesh({"data": n // 8, "seq": 4, "model": 2})
        kw = tiny_generate_kwargs(pipe, num_inference_steps=1, output_type="latent", num_frames=3 * tc + 1)
        _finite(pipe.generate(**kw))
        # the documented routes of the quoted slices
        for args, want, fallback in (((48, 16, 2), "sp_allgather", True), ((48, 16, 1), "sp_ulysses", False),
                                     ((48, 8, 2), "sp_ulysses", False), ((6, 4, 2), "sp_allgather", True)):
            backend, reason = route_seq_backend("sp_ulysses", *args)
            if backend != want or bool(reason) != fallback:
                raise AssertionError(f"route_seq_backend('sp_ulysses', {args}) gave {backend}, {reason}")

    phases = [
        (f"S2VPipeline.generate mesh={dp_tp} (dp x tp)", generate_dp_tp),
        (f"S2VPipeline.generate mesh={{'seq': {n}}} (frame shards + CP-VAE decode)", generate_seq),
        (f"S2VPipeline.generate mesh={ulysses_mesh} attention=sp_ulysses", generate_ulysses),
        (f"S2VPipeline.generate mesh={{'seq': {n}}} attention=sp_windowed", generate_sp_windowed),
        (f"runtime-LoRA swap under mesh={dp_tp} + generate", runtime_lora),
        (f"sharded LoRA train step mesh={dp_tp}", lora_step),
        (f"FSDP full fine-tune step (state sharded 1/{n})", fsdp_step),
        (f"QLoRA train step (int8 base) mesh={dp_tp}", qlora_step),
    ]
    if n >= 16 and n % 8 == 0:
        phases.append((f"{n}-rank phase: dp{n // 8} x sp8 sp_ulysses, dp{n // 8} x sp4 x tp2 -> sp_allgather",
                       sixteen))
    return phases


def _rank_main(rank: int, world_size: int, store_path: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world_size), rank=rank,
                            world_size=world_size, timeout=timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    try:
        phases = _phases(world_size)
        for i, (name, fn) in enumerate(phases, 1):
            if rank == 0:
                print(f"dryrun: [{i}/{len(phases)}] {name} ...", flush=True)
            t0 = time.perf_counter()
            try:
                fn()
            except Exception as e:  # the phase's line says what failed; the rank exits non-zero
                print(f"dryrun: [{i}/{len(phases)}] {name} FAILED on rank {rank}: {type(e).__name__}: {e}\n"
                      f"{traceback.format_exc()}", flush=True)
                os._exit(1)
            dist.barrier()
            if rank == 0:
                print(f"dryrun: [{i}/{len(phases)}] {name} OK ({time.perf_counter() - t0:.1f} s)", flush=True)
    finally:
        dist.destroy_process_group()


def run(ranks: int, timeout_s: float) -> int:
    """Spawn the ranks and wait; returns 0 when every rank ran every phase."""
    import torch.multiprocessing as mp

    t0 = time.perf_counter()
    print(f"dryrun: {ranks} gloo ranks on the CPU", flush=True)
    with tempfile.TemporaryDirectory(prefix="s2v_dryrun_") as tmp:
        ctx = mp.start_processes(_rank_main, args=(ranks, os.path.join(tmp, "store")), nprocs=ranks, join=False,
                                 start_method="spawn")
        deadline = time.monotonic() + timeout_s
        try:
            while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
                if time.monotonic() >= deadline:
                    print(f"dryrun: the ranks did not finish within {timeout_s:.0f} s", flush=True)
                    return 1
        except mp.ProcessExitedException as e:
            print(f"dryrun: FAILED: {e}", flush=True)
            return 1
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()
    print(f"dryrun: {ranks} ranks OK ({time.perf_counter() - t0:.1f} s)", flush=True)
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--ranks", type=int, default=8, help="gloo ranks to spawn on the CPU (default 8)")
    parser.add_argument("--timeout", type=float, default=900.0, help="seconds before the run is called failed")
    args = parser.parse_args(argv)
    if args.ranks < 1:
        parser.error("--ranks must be at least 1")
    return run(args.ranks, args.timeout)


if __name__ == "__main__":
    sys.exit(main())
