"""The port's trainer CLI (``python -m s2v_torch.train``) against the JAX
package's (``s2v_tpu/train.py``) on the CPU, on a tiny snapshot the JAX
package writes (``_torch_parity.write_tiny_snapshot``) and a folder of three
9-frame 32x32 clips.

* ``get_args``: every flag of JAX's, with its default, choices, type and
  action (the port adds ``--device`` and ``--dtype``).
* LoRA mode end to end: the files and their names; the exported adapters'
  keys and shapes equal to JAX's ``export_lora_to_reference_format``; the
  per-micro-step losses equal to JAX's ``make_lora_train_step`` fed the
  batches the port's run made (positions included) and JAX's own draws
  (its ``fold_in(PRNGKey(seed), micro)`` timesteps and noise, injected into
  the port, ROADMAP C.6), from JAX's adapter init: fp32, 1e-4 relative.
* Resume: from ``train_state_1`` to the end equals the uninterrupted run bit
  for bit (tolerance 0), in LoRA and in full mode; a state of other flags
  raises JAX's ``_RESUME_MISMATCH`` text.
* Full mode with EMA: its ``snapshot/`` loads back through ``from_pretrained``
  and holds the EMA weights.
* The C.3/C.19 pin: JAX's batches carry no positions, the port's do.
* The guards: the frame-alignment message is JAX's; ``--mesh dp2`` with a
  batch of 1 and ``--fsdp_base`` without a data dim of 2 raise JAX's
  refusals, a sequence-parallel backend without ``--mesh`` raises (the
  meshes themselves run in ``tests/test_torch_mesh_train.py``).
"""

import argparse
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from _torch_parity import write_tiny_snapshot
from s2v_tpu import train as j_train
from s2v_tpu.training import data as j_data
from s2v_tpu.training import lora as j_lora
from s2v_tpu.training import optim as j_optim
from s2v_torch import train
from s2v_torch.loaders.jax_params import lora_from_jax
from s2v_torch.loaders.safetensors_io import load_safetensors
from s2v_torch.training import lora as lora_mod
from s2v_torch.training.data import VideoFolderDataset

LOSS_RTOL = 1e-4
SEED = 5


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    import cv2

    root = tmp_path_factory.mktemp("train_cli")
    snap, _ = write_tiny_snapshot(root)
    clips = root / "clips"
    clips.mkdir()
    for i in range(3):
        rng = np.random.RandomState(i)
        writer = cv2.VideoWriter(str(clips / f"clip{i}.mp4"), cv2.VideoWriter_fourcc(*"mp4v"), 8, (32, 32))
        for _ in range(10):
            writer.write((rng.rand(32, 32, 3) * 255).astype(np.uint8))
        writer.release()
    (clips / "prompts.txt").write_text("a pig\na cat\na dog\n")
    return root, snap, str(clips)


def _argv(tiny, out, *extra):
    root, snap, clips = tiny
    return ["--pretrained_model_name_or_path", snap, "--dataset_dir", clips, "--output_dir", str(out),
            "--height", "32", "--width", "32", "--max_num_frames", "9", "--rank", "4", "--lora_alpha", "8",
            "--device", "cpu", "--dtype", "float32", "--seed", str(SEED), *extra]


def _parser(get_args):
    """The ArgumentParser a ``get_args`` builds."""
    captured = []
    real = argparse.ArgumentParser.parse_args

    def capture(self, args=None, namespace=None):
        captured.append(self)
        return real(self, args, namespace)

    argparse.ArgumentParser.parse_args = capture
    try:
        get_args(["--pretrained_model_name_or_path", "x", "--dataset_dir", "y"])
    finally:
        argparse.ArgumentParser.parse_args = real
    return captured[0]


def test_get_args_keeps_every_jax_flag():
    theirs = {a.dest: a for a in _parser(j_train.get_args)._actions if a.dest != "help"}
    mine = {a.dest: a for a in _parser(train.get_args)._actions if a.dest != "help"}
    assert set(mine) - set(theirs) == {"device", "dtype"}
    for dest, a in theirs.items():
        b = mine[dest]
        assert (b.option_strings, b.default, b.choices, b.type, b.required, type(b)) == (
            a.option_strings, a.default, a.choices, a.type, a.required, type(a)), dest
    argv = ["--pretrained_model_name_or_path", "s", "--dataset_dir", "d", "--optimizer", "prodigy", "--remat",
            "seg3", "--lr_scheduler", "cosine", "--ema_decay", "0.99", "--train_mode", "full"]
    got, want = vars(train.get_args(argv)), vars(j_train.get_args(argv))
    assert {k: got[k] for k in want} == want


def _jax_draws(micro, shape):
    """The draws ``s2v_tpu.training.full.vpred_loss`` makes at micro-step
    ``micro`` of the JAX CLI (``fold_in(PRNGKey(seed), micro)``, :69-71)."""
    k_t, k_n = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(SEED), micro))
    ts = jax.random.randint(k_t, (shape[0],), 0, 1000)
    return torch.from_numpy(np.asarray(ts)), torch.from_numpy(np.asarray(jax.random.normal(k_n, shape, jnp.float32)))


@pytest.fixture(scope="module")
def lora_run(tiny, tmp_path_factory):
    """One LoRA run (3 optimizer steps of 2 micro-steps, validation at step
    2) from JAX's adapter init, with JAX's draws injected and every batch
    and loss recorded; and JAX's base tree and init."""
    from s2v_tpu.pipelines.s2v import S2VPipeline as JPipeline

    _, snap, _ = tiny
    jpipe = JPipeline.from_pretrained(snap, dtype=jnp.float32)
    spec_j = j_lora.LoRASpec(rank=4, alpha=8.0)
    init_j = jax.tree.map(np.asarray, j_lora.init_lora_params(jax.random.PRNGKey(SEED), jpipe.transformer_params,
                                                              spec_j))
    record = []
    real_make = lora_mod.make_lora_train_step

    def make(*args, **kw):
        init, step = real_make(*args, **kw)

        def recorded(lora, opt_state, batch, generator=None):
            ts, noise = _jax_draws(len(record), batch["video_latents"].shape)
            out = step(lora, opt_state, batch, timesteps=ts, noise=noise)
            record.append(({k: v.numpy().copy() for k, v in batch.items()}, out[2].item()))
            return out

        return init, recorded

    out = tmp_path_factory.mktemp("lora_out")
    mp = pytest.MonkeyPatch()
    mp.setattr(lora_mod, "init_lora_params", lambda gen, base, spec: lora_from_jax(init_j, device="cpu"))
    mp.setattr(lora_mod, "make_lora_train_step", make)
    try:
        train.main(train.get_args(_argv(tiny, out, "--max_train_steps", "3", "--gradient_accumulation_steps", "2",
                                        "--checkpointing_steps", "1", "--lr_scheduler", "cosine",
                                        "--lr_warmup_steps", "1", "--learning_rate", "1e-2", "--validation_prompt",
                                        "a pig", "--validation_steps", "2", "--validation_num_inference_steps",
                                        "2")))
    finally:
        mp.undo()
    return out, record, jpipe, spec_j, init_j


def test_lora_run_writes_jax_named_files_and_exports(lora_run):
    out, record, jpipe, spec_j, init_j = lora_run
    assert sorted(os.listdir(out)) == [train.LORA_FILE, "samples", "train_state_1", "train_state_2",
                                       "train_state_3"]
    assert os.listdir(out / "samples") == ["step2_p0_v0.mp4"] and os.path.getsize(out / "samples" /
                                                                                   "step2_p0_v0.mp4") > 0
    got = load_safetensors(str(out / train.LORA_FILE))
    want = j_lora.export_lora_to_reference_format(init_j, spec_j, jpipe.transformer_cfg)
    assert sorted(got) == sorted(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape and got[k].dtype == torch.float32


def test_lora_losses_match_jax_train_step(lora_run):
    """JAX's ``make_lora_train_step`` (remat, the same optimizer surface)
    from the same init on the port's batches and JAX's draws."""
    _, record, jpipe, spec_j, init_j = lora_run
    assert len(record) == 6  # 3 steps x 2 micro-steps
    opt = j_optim.OptimizerSpec(learning_rate=1e-2, lr_scheduler="cosine", lr_warmup_steps=1, max_train_steps=3,
                                max_grad_norm=1.0, weight_decay=1e-4, beta1=0.9, beta2=0.95, epsilon=1e-8,
                                gradient_accumulation_steps=2)
    init, step = j_lora.make_lora_train_step(jpipe.transformer_params, jpipe.transformer_cfg, spec_j,
                                             jpipe.scheduler_cfg, optimizer_spec=opt, remat=True)
    lj = jax.tree.map(jnp.asarray, init_j)
    sj = init(lj)
    for micro, (batch, loss) in enumerate(record):
        for key in ("rope_cos", "rope_sin"):
            assert key in batch  # the positions the model samples with (C.3)
        rng = jax.random.fold_in(jax.random.PRNGKey(SEED), micro)
        lj, sj, loss_j = step(lj, sj, {k: jnp.asarray(v) for k, v in batch.items()}, rng)
        assert abs(loss - float(loss_j)) <= LOSS_RTOL * abs(float(loss_j)), (micro, loss, float(loss_j))


def test_lora_resume_equals_the_uninterrupted_run(tiny, lora_run, tmp_path, monkeypatch):
    """A run resumed from ``train_state_1`` (the same flags and draws) ends
    with the uninterrupted run's adapters and optimizer state, bit for bit."""
    out, record, _, _, init_j = lora_run
    monkeypatch.setattr(lora_mod, "init_lora_params", lambda gen, base, spec: lora_from_jax(init_j, device="cpu"))
    real_make = lora_mod.make_lora_train_step

    def make(*args, **kw):  # the first run's draws, from micro-step 2 on
        init, step = real_make(*args, **kw)
        calls = [2]

        def injected(lora, opt_state, batch, generator=None):
            ts, noise = _jax_draws(calls[0], batch["video_latents"].shape)
            calls[0] += 1
            return step(lora, opt_state, batch, timesteps=ts, noise=noise)

        return init, injected

    monkeypatch.setattr(lora_mod, "make_lora_train_step", make)
    train.main(train.get_args(_argv(tiny, tmp_path, "--max_train_steps", "3", "--gradient_accumulation_steps",
                                    "2", "--checkpointing_steps", "1", "--lr_scheduler", "cosine",
                                    "--lr_warmup_steps", "1", "--learning_rate", "1e-2", "--resume_from_checkpoint",
                                    str(out / "train_state_1"))))
    a = load_safetensors(str(out / "train_state_3" / "tensors.safetensors"))
    b = load_safetensors(str(tmp_path / "train_state_3" / "tensors.safetensors"))
    assert sorted(a) == sorted(b) and all(torch.equal(a[k], b[k]) for k in a)
    assert (out / "train_state_3" / "tree.json").read_text() == (tmp_path / "train_state_3" / "tree.json").read_text()
    with pytest.raises(SystemExit, match="cannot restore .*train_state_1: the train-state tree must match"):
        train.main(train.get_args(_argv(tiny, tmp_path / "x", "--max_train_steps", "3",
                                        "--resume_from_checkpoint", str(out / "train_state_1"))))


def test_full_mode_with_ema_snapshot_and_resume(tiny, tmp_path):
    """Full mode (prodigy, remat seg, EMA 0.9): the snapshot holds the EMA
    weights and loads back through ``from_pretrained``; resuming from step 1
    ends where the uninterrupted run ended, bit for bit."""
    from s2v_torch.pipelines.s2v import S2VPipeline

    flags = ("--train_mode", "full", "--ema_decay", "0.9", "--optimizer", "prodigy", "--learning_rate", "1.0",
             "--remat", "seg", "--max_train_steps", "2", "--checkpointing_steps", "1")
    train.main(train.get_args(_argv(tiny, tmp_path / "a", *flags)))
    assert sorted(os.listdir(tmp_path / "a")) == ["snapshot", "train_state_1", "train_state_2"]
    pipe = S2VPipeline.from_pretrained(str(tmp_path / "a" / "snapshot"), dtype=torch.float32, device="cpu")
    state = load_safetensors(str(tmp_path / "a" / "train_state_2" / "tensors.safetensors"))
    ema = state["opt_state/1/proj_out/weight"]
    assert not torch.equal(ema, state["params/proj_out/weight"])
    assert torch.equal(pipe.transformer_params["proj_out"]["weight"], ema.bfloat16().float())
    train.main(train.get_args(_argv(tiny, tmp_path / "b", *flags, "--resume_from_checkpoint",
                                    str(tmp_path / "a" / "train_state_1"))))
    b = load_safetensors(str(tmp_path / "b" / "train_state_2" / "tensors.safetensors"))
    assert sorted(b) == sorted(state) and all(torch.equal(state[k], b[k]) for k in state)


def test_jax_batches_carry_no_positions_and_the_ports_do(tiny):
    """ROADMAP C.3/C.19, pinned: JAX's ``latent_batches`` (what its CLI trains
    on) yields no RoPE or sincos table, so its CLI trains without positions;
    the port's CLI adds the tables ``generate`` uses."""
    from s2v_tpu.pipelines.s2v import S2VPipeline as JPipeline
    from s2v_torch.pipelines.s2v import S2VPipeline

    _, snap, clips = tiny
    jpipe = JPipeline.from_pretrained(snap, dtype=jnp.float32)
    ds = j_data.VideoFolderDataset(clips, num_frames=9, height=32, width=32)
    batch = next(j_data.latent_batches(ds, jpipe, seed=0))
    assert sorted(batch) == ["ref_latents", "text_embeds", "video_latents"]
    pipe = S2VPipeline.from_pretrained(snap, dtype=torch.float32, device="cpu")
    args = train.get_args(_argv(tiny, "unused"))
    got = next(train._batches(args, pipe, VideoFolderDataset(clips, 9, 32, 32), 0, {}))
    cos, sin = pipe.prepare_rope(32, 32, got["video_latents"].shape[1])
    assert torch.equal(got["rope_cos"], cos) and torch.equal(got["rope_sin"], sin)


@pytest.mark.parametrize("frames", [10, 8])
def test_frame_alignment_guard_says_what_jax_says(tiny, tmp_path, frames):
    want = f"--max_num_frames {frames} must satisfy (F - 1) % 4 == 0 (e.g. {((frames - 1) // 4) * 4 + 1})"
    argv = _argv(tiny, tmp_path)
    argv[argv.index("--max_num_frames") + 1] = str(frames)
    with pytest.raises(SystemExit, match=r"must satisfy \(F - 1\) % 4 == 0") as got:
        train.main(train.get_args(argv))
    assert str(got.value) == want


@pytest.mark.parametrize("extra", [("--mesh", "dp2"), ("--fsdp_base",), ("--attention_backend", "sp_windowed"),
                                   ("--attention_backend", "ring")])
def test_multi_card_flags_raise_naming_a9(tiny, tmp_path, extra):
    """Every multi-card flag is ported; what still raises, before anything
    loads, are JAX's refusals (a batch of 1 over a data dim of 2,
    ``--fsdp_base`` without a data dim of 2) and a sequence-parallel
    backend without a mesh."""
    says = {"--mesh": r"--train_batch_size 1 must be divisible by the data mesh axis \(2\)",
            "--fsdp_base": "--fsdp_base needs a data mesh axis >= 2"}.get(extra[0], "needs --mesh")
    with pytest.raises(SystemExit, match=says):
        train.main(train.get_args(_argv(tiny, tmp_path, *extra)))
