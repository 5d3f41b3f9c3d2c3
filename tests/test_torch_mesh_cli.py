"""``--mesh`` in the port's entry points: ``python -m torch.distributed.run
--standalone --nproc_per_node 2 -m s2v_torch.cli --mesh sp2`` (gloo ranks
on the CPU) writes the clip that one process without a mesh writes, from
rank 0 alone; ``-m s2v_torch.serve --mesh sp2`` answers a request with that
clip, rank 0 handing it to rank 1, and a shutdown stops both ranks; ranks
that fail a request differently stop the daemon on both ranks.  The
``data`` and ``model`` dims run too: ``--mesh dp2`` (the CFG rows split),
``tp2`` (megatron TP), ``sp2,tp2`` (four ranks) and ``tp2`` with
``--text_encoder_device mesh`` write the clip of one process; a mesh whose
size is not the world size raises.  The clips are compared as decoded
frames: the sharded model is the same model in other roundings."""

import os
import subprocess
import sys
import time

import cv2
import numpy as np
import pytest
from PIL import Image

from _torch_parity import write_tiny_snapshot
from _torch_sp_worker import run_ranks
from s2v_torch import cli
from s2v_torch.serving.client import request

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# decoded frames of the ring's clip against one process's, in 8-bit levels
# (both 0 on the machine the test was written on: the same frames)
MEAN_LEVELS, MAX_LEVELS = 0.1, 4
# a model dim's fp32 clip against one process's: the same mean, and a larger
# largest level, as mp4v's lossy coding turns a one-level flip of a pixel
# into a difference over its block
TP_MAX_LEVELS = 32
RUN_TIMEOUT_S = 120


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    root = tmp_path_factory.mktemp("mesh_cli")
    snap, lora = write_tiny_snapshot(root)
    ref = str(root / "ref.png")
    Image.fromarray((np.random.RandomState(0).rand(32, 32, 3) * 255).astype("uint8")).save(ref)
    return snap, lora, ref


def _argv(tiny, out, *extra):
    """13 frames: 4 latent frames, which 2 ranks decode context-parallel."""
    snap, lora, ref = tiny
    return ["--pretrained_model_name_or_path", snap, "--checkpoint_path", lora, "--ref_img_path", ref,
            "--prompt", "<cls> a pig walking", "--height", "32", "--width", "32", "--max_num_frames", "13",
            "--num_inference_steps", "2", "--output_dir", str(out), "--device", "cpu", "--attention_backend",
            "pallas", *extra]


def _torchrun(nproc, module, args, **kw):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    return subprocess.Popen([sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
                             str(nproc), "-m", module, *args], env=env, cwd=REPO, **kw)


def _frames(path):
    cap = cv2.VideoCapture(str(path))
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(frame)
    cap.release()
    return np.stack(frames).astype(np.float64)


@pytest.fixture(scope="module")
def one_rank_clip(tiny, tmp_path_factory):
    out = tmp_path_factory.mktemp("one_rank")
    cli.main(_argv(tiny, out))
    return _frames(out / "output.mp4")


@pytest.fixture(scope="module")
def one_rank_clip_fp32(tiny, tmp_path_factory):
    out = tmp_path_factory.mktemp("one_rank_fp32")
    cli.main(_argv(tiny, out, "--dtype", "float32"))
    return _frames(out / "output.mp4")


def _close(got, want, max_levels=MAX_LEVELS):
    assert got.shape == want.shape and got.shape[1:] == (32, 32, 3)
    diff = np.abs(got - want)
    assert diff.mean() <= MEAN_LEVELS and diff.max() <= max_levels, (diff.mean(), diff.max())


def test_cli_mesh_sp2_writes_the_clip_of_one_rank(tiny, one_rank_clip, tmp_path):
    proc = _torchrun(2, "s2v_torch.cli", _argv(tiny, tmp_path / "out", "--mesh", "sp2"), stdout=subprocess.PIPE,
                     stderr=subprocess.PIPE, text=True)
    out, err = proc.communicate(timeout=RUN_TIMEOUT_S)
    assert proc.returncode == 0, err[-3000:]
    assert out.count("Inference completed") == 1 and out.count("[s2v_torch] wrote") == 1, out
    assert "seq ring of 2" in out
    assert sorted(os.listdir(tmp_path / "out")) == ["output.mp4"]
    _close(_frames(tmp_path / "out" / "output.mp4"), one_rank_clip)


def test_daemon_mesh_sp2_answers_the_clip_of_one_rank(tiny, one_rank_clip, tmp_path):
    snap, lora, ref = tiny
    sock, ready = str(tmp_path / "s.sock"), tmp_path / "ready"
    log = open(tmp_path / "daemon.log", "w")
    proc = _torchrun(2, "s2v_torch.serve", ["--pretrained_model_name_or_path", snap, "--checkpoint_path", lora,
                                           "--socket", sock, "--ready_file", str(ready), "--device", "cpu",
                                           "--attention_backend", "pallas", "--mesh", "sp2"],
                     stdout=log, stderr=subprocess.STDOUT)
    try:
        deadline = time.monotonic() + RUN_TIMEOUT_S
        while not ready.exists():
            assert proc.poll() is None, (tmp_path / "daemon.log").read_text()[-3000:]
            assert time.monotonic() < deadline, "the daemon did not get ready"
            time.sleep(0.2)
        clip = tmp_path / "served.mp4"
        resp = request(sock, {"op": "generate", "prompt": "<cls> a pig walking", "ref_img_path": ref,
                              "output_path": str(clip), "height": 32, "width": 32, "num_frames": 13,
                              "num_inference_steps": 2, "guidance_scale": 6.0, "seed": 420})
        assert resp["status"] == "ok", resp
        assert resp["outputs"] == [str(clip)]
        _close(_frames(clip), one_rank_clip)
        assert request(sock, {"op": "stats"})["requests_served"] == 1
        assert request(sock, {"op": "shutdown"})["status"] == "ok"
        assert proc.wait(timeout=60) == 0  # both ranks stopped
    finally:
        if proc.poll() is None:
            proc.kill()
        log.close()
    assert sorted(p.name for p in tmp_path.iterdir() if p.suffix == ".mp4") == ["served.mp4"]


def test_daemon_ranks_that_fail_differently_stop_every_rank(tmp_path):
    """Two gloo ranks of a mesh daemon: a request that every rank serves is
    answered, one that fails alike on every rank is answered with its error
    and the ranks serve on, and one that fails on rank 1 alone ends the loop
    on both ranks (rank 0 waits for every rank's outcome before it answers)."""
    requests = [{"op": "ping", "fail_on": []}, {"op": "generate", "fail_on": [0, 1]},
                {"op": "generate", "fail_on": [1]}, {"op": "shutdown", "fail_on": []}]
    first, second = run_ranks(2, {"d": ("daemon_outcomes", dict(requests=requests))}, tmp_path, timeout_s=60)
    seen = first["d"]["seen"]
    assert seen[:2] == ["ok", "error: this request fails here"], seen
    assert len(seen) == 3 and seen[2].startswith("out of step:"), seen
    assert "rank 0: ok; rank 1: ValueError: this request fails here" in seen[2]
    assert second["d"]["seen"] == ["out of step"]


@pytest.mark.parametrize("flags", [["--mesh", "dp2"], ["--mesh", "tp2"], ["--mesh", "sp2,tp2"],
                                   ["--text_encoder_device", "mesh"]], ids=["dp2", "tp2", "sp2_tp2", "t5_mesh"])
def test_data_model_dims_and_t5_on_the_mesh_raise_naming_a9(tiny, one_rank_clip, one_rank_clip_fp32, tmp_path,
                                                            flags):
    """Under torchrun each mesh writes one process's clip, from rank 0 alone
    (T5 on the mesh runs on a ``tp2`` mesh); one process given ``dp2``
    raises, naming the torchrun it needs.  A model dim adds its ranks'
    partial sums of the row-parallel linears, rounded to the model's dtype
    each (as JAX's bf16 psum does), so its runs are in fp32 and held to the
    fp32 clip of one process; ``dp2`` runs each row as one process does."""
    from s2v_torch.parallel.sharding import parse_mesh_spec

    if flags[0] == "--text_encoder_device":
        flags = flags + ["--mesh", "tp2"]
    ranks = int(np.prod(list(parse_mesh_spec(flags[-1]).values())))
    tp = "tp" in flags[-1]
    if tp:
        flags = ["--dtype", "float32", *flags]
    proc = _torchrun(ranks, "s2v_torch.cli", _argv(tiny, tmp_path / "out", *flags), stdout=subprocess.PIPE,
                     stderr=subprocess.PIPE, text=True)
    out, err = proc.communicate(timeout=RUN_TIMEOUT_S)
    assert proc.returncode == 0, err[-3000:]
    assert out.count("[s2v_torch] wrote") == 1 and f"mesh {flags[-1]}" in out, out
    if tp:
        _close(_frames(tmp_path / "out" / "output.mp4"), one_rank_clip_fp32, TP_MAX_LEVELS)
    else:
        _close(_frames(tmp_path / "out" / "output.mp4"), one_rank_clip)
    if flags == ["--mesh", "dp2"]:
        with pytest.raises(ValueError, match="torchrun --nproc_per_node 2"):
            cli.main(_argv(tiny, tmp_path / "one", *flags))


def test_from_pretrained_t5_on_the_mesh_raises_naming_a9(tiny):
    """T5 on the mesh needs a mesh; on a one-rank ``tp1`` mesh it runs
    sliced (the one-rank collectives copy) and encodes what the T5 on the
    device encodes, bit for bit."""
    import torch
    import torch.distributed as dist

    from s2v_torch.pipelines.s2v import S2VPipeline

    with pytest.raises(ValueError, match='text_encoder_device="mesh" needs mesh'):
        S2VPipeline.from_pretrained(tiny[0], text_encoder_device="mesh", device="cpu")
    plain = S2VPipeline.from_pretrained(tiny[0], dtype=torch.float32, device="cpu")
    try:
        on_mesh = S2VPipeline.from_pretrained(tiny[0], dtype=torch.float32, text_encoder_device="mesh", mesh="tp1",
                                              device="cpu")
        assert on_mesh.t5_on_mesh and on_mesh._t5_specs is not None
        got = on_mesh.encode_prompt("<cls> a pig walking")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    assert torch.equal(got, plain.encode_prompt("<cls> a pig walking"))


def test_a_mesh_of_another_size_than_the_world_raises():
    """One process, no torchrun: a one-rank group, which sp2 does not fit."""
    import torch.distributed as dist

    from s2v_torch.parallel.sharding import make_mesh

    try:
        with pytest.raises(ValueError, match="has 2 ranks but the process group has 1"):
            make_mesh("sp2", "cpu")
        assert make_mesh({"seq": 1}, "cpu").size() == 1
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_parse_mesh_spec_matches_jax():
    from s2v_tpu.parallel.sharding import parse_mesh_spec as j_parse
    from s2v_torch.parallel.sharding import parse_mesh_spec

    for spec in ("sp8", "seq8", "dp2,tp4", "tp2, sp4", "data1,model2,seq4"):
        assert parse_mesh_spec(spec) == j_parse(spec)
    for bad in ("xp2", "sp", "sp0", "sp2,seq2", ""):
        with pytest.raises(ValueError) as want:
            j_parse(bad)
        with pytest.raises(ValueError, match=str(want.value).replace("(", r"\(").replace(")", r"\)")):
            parse_mesh_spec(bad)
