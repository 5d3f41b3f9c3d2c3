"""The port's serving daemon on a tiny snapshot on the CPU: the protocol's
ops and error responses, over its socket and through ``python -m
s2v_torch.serve`` (daemon and client mode), beside the JAX package's daemon
on the same snapshot and requests (the same keys, statuses and shapes)."""

import json
import os
import subprocess
import sys
import threading
import time

import cv2
import numpy as np
import pytest
from PIL import Image

from _torch_parity import write_tiny_snapshot
from s2v_torch.serve import get_args as serve_args
from s2v_torch.serve import main as serve_main
from s2v_torch.serving import ServingDaemon, request
from s2v_torch.serving import daemon as daemon_mod

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GEO = dict(height=32, width=32, num_frames=9, num_inference_steps=2)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    root = tmp_path_factory.mktemp("serve")
    snap, lora = write_tiny_snapshot(root)
    ref = str(root / "ref.png")
    Image.fromarray((np.random.RandomState(0).rand(32, 32, 3) * 255).astype("uint8")).save(ref)
    return snap, lora, ref, root


@pytest.fixture(scope="module")
def daemon(tiny):
    from s2v_torch.pipelines.s2v import S2VPipeline

    snap, _, _, root = tiny
    pipe = S2VPipeline.from_pretrained(snap, device="cpu")
    return ServingDaemon(pipe, str(root / "s2v.sock"))


def _start(d):
    thread = threading.Thread(target=d.serve_forever, daemon=True)
    thread.start()
    for _ in range(200):
        if os.path.exists(d.socket_path):
            break
        time.sleep(0.05)
    return thread


def _frames(path):
    cap = cv2.VideoCapture(path)
    n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    ok, first = cap.read()
    cap.release()
    return n, first if ok else None


def test_ping_stats_unknown(daemon):
    assert daemon.handle({"op": "ping"}) == {"status": "ok", "pong": True}
    stats = daemon.handle({"op": "stats"})
    assert stats["status"] == "ok" and stats["compiled_configs"] == 0
    assert set(stats["generate_latency_s"]) == {"p50", "p90", "max"}
    assert daemon.handle({"op": "bogus"}) == {"status": "error", "error": "unknown op 'bogus'"}


def test_warmup_then_generate(daemon, tiny, tmp_path):
    _, _, ref, _ = tiny
    wu = daemon.handle({"op": "warmup", **GEO})
    assert wu["status"] == "ok" and wu["compiled"] is False and wu["shape"] == [1, 9, 32, 32, 3]
    g1 = daemon.handle({"op": "generate", "prompt": "a pig", "ref_img_path": ref,
                        "output_path": str(tmp_path / "clip.mp4"), "seed": 1, **GEO})
    assert g1["status"] == "ok", g1
    assert g1["outputs"] == [str(tmp_path / "clip.mp4")] and _frames(g1["outputs"][0])[0] == 9
    g2 = daemon.handle({"op": "generate", "prompt": "a pig", "ref_img_path": ref,
                        "output_path": str(tmp_path / "clip2.mp4"), "seed": 2, "use_dpm": True,
                        "segment_steps": 1, "cfg_skip_threshold": 0.02, "use_dynamic_cfg": True, **GEO})
    assert g2["status"] == "ok", g2
    f1, f2 = _frames(g1["outputs"][0])[1], _frames(g2["outputs"][0])[1]
    assert float(np.abs(f1.astype(np.float64) - f2.astype(np.float64)).mean()) > 0.5  # another seed and sampler
    assert daemon.pipe.stats["cfg_skipped_steps"] == 1


def test_generate_missing_args(daemon):
    assert daemon.handle({"op": "generate"}) == {"status": "error", "error": "generate needs prompt and ref_img_path"}
    r = daemon.handle({"op": "generate", "prompt": "x", "ref_img_path": "/nope.png"})
    assert r["status"] == "error" and "not found" in r["error"]
    r = daemon.handle({"op": "load_lora", "checkpoint_path": "/nope"})
    assert r["status"] == "error" and "not found" in r["error"]


def test_prompt_list_and_stats(daemon, tiny, tmp_path):
    _, _, ref, _ = tiny
    r = daemon.handle({"op": "generate", "prompt": ["a pig", "a dog"], "ref_img_path": ref,
                       "output_path": str(tmp_path / "multi.mp4"), "seed": 5, **GEO})
    assert r["status"] == "ok", r
    assert r["shape"] == [2, 9, 32, 32, 3]
    assert r["outputs"] == [str(tmp_path / "multi_0.mp4"), str(tmp_path / "multi_1.mp4")]
    assert all(os.path.getsize(p) > 0 for p in r["outputs"])
    stats = daemon.handle({"op": "stats"})
    assert stats["clips_generated"] >= 2 and stats["generate_latency_s"]["max"] is not None


@pytest.mark.parametrize("mode", ["merge", "runtime"])
def test_load_lora(daemon, tiny, tmp_path, mode):
    from s2v_torch.models.transformer import RUNTIME_LORA_KEY

    _, lora, ref, _ = tiny
    req = {"op": "generate", "prompt": "a pig", "ref_img_path": ref, "seed": 1, **GEO}
    base = daemon.handle({**req, "output_path": str(tmp_path / "base.mp4")})
    r = daemon.handle({"op": "load_lora", "checkpoint_path": lora, "lora_mode": mode})
    assert r["status"] == "ok" and r["lora_mode"] == mode and r["lora_checkpoint"] == lora
    assert r["compiled_configs_kept"] == 0 and r["seconds"] >= 0
    assert (RUNTIME_LORA_KEY in daemon.pipe.transformer_params) == (mode == "runtime")
    adapted = daemon.handle({**req, "output_path": str(tmp_path / "lora.mp4")})
    assert adapted["status"] == "ok" and daemon.handle({"op": "stats"})["lora_checkpoint"] == lora
    b, a = _frames(base["outputs"][0])[1], _frames(adapted["outputs"][0])[1]
    assert not np.array_equal(a, b)  # the adapter changed the clip
    # inline: back to the base weights, then the same adapter again in the same request
    back = daemon.handle({**req, "lora_checkpoint": None, "output_path": str(tmp_path / "back.mp4")})
    assert back["status"] == "ok" and back["lora_checkpoint"] is None
    again = daemon.handle({**req, "lora_checkpoint": lora, "lora_mode": mode,
                           "output_path": str(tmp_path / "again.mp4")})
    assert again["lora_checkpoint"] == lora and daemon.lora_mode == mode
    daemon.handle({"op": "load_lora", "checkpoint_path": None})


def test_socket_roundtrip_and_client_exit_codes(daemon, tiny):
    d = ServingDaemon(daemon.pipe, str(tiny[3] / "cli.sock"))
    thread = _start(d)
    assert request(d.socket_path, {"op": "ping"})["pong"] is True
    assert request(d.socket_path, {"op": "stats"})["requests_served"] >= 1
    assert request(d.socket_path, {"op": "generate", "prompt": 3})["status"] == "error"  # and still serving
    rc_ok = serve_main(serve_args(["--socket", d.socket_path, "--request", '{"op": "ping"}']))
    rc_err = serve_main(serve_args(["--socket", d.socket_path, "--request", '{"op": "bogus"}']))
    assert rc_ok == 0 and rc_err == 1
    assert serve_main(serve_args(["--socket", d.socket_path, "--request", '{"op": "shutdown"}'])) == 0
    thread.join(timeout=10)
    assert not thread.is_alive() and not os.path.exists(d.socket_path)


def test_idle_client_is_dropped(daemon, tiny, monkeypatch):
    import socket

    monkeypatch.setattr(daemon_mod, "CLIENT_IDLE_TIMEOUT_S", 0.2)
    d = ServingDaemon(daemon.pipe, str(tiny[3] / "idle.sock"))
    thread = _start(d)
    idle = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    idle.connect(d.socket_path)  # sends nothing
    try:
        assert request(d.socket_path, {"op": "ping"}, timeout=10)["pong"] is True
    finally:
        idle.close()
    request(d.socket_path, {"op": "shutdown"})
    thread.join(timeout=10)
    assert not thread.is_alive()


def test_serve_mesh_raises_naming_its_roadmap_item(tiny):
    """Every mesh dim is ported; what still raises before anything loads is
    T5 on the mesh without a mesh, and a mesh that is not the world's size
    (one process here: ``dp2`` needs two, under torchrun)."""
    import torch.distributed as dist

    with pytest.raises(ValueError, match="--text_encoder_device mesh needs --mesh"):
        serve_main(serve_args(["--pretrained_model_name_or_path", tiny[0], "--text_encoder_device", "mesh",
                               "--device", "cpu"]))
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 2"):
        serve_main(serve_args(["--pretrained_model_name_or_path", tiny[0], "--mesh", "dp2", "--device", "cpu"]))
    assert not dist.is_initialized()  # the group the entry point made is gone


def test_serve_module_daemon_and_client(tiny, tmp_path):
    """``python -m s2v_torch.serve`` as users start it, in a fresh process
    that never imports JAX, with a merged LoRA, driven by the client mode."""
    snap, lora, ref, _ = tiny
    sock, ready = str(tmp_path / "d.sock"), tmp_path / "ready"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    code = ("import runpy, sys\nsys.argv = ['s2v_torch.serve'] + sys.argv[1:]\n"
            "try:\n    runpy.run_module('s2v_torch.serve', run_name='__main__')\nexcept SystemExit:\n"
            "    assert not [m for m in sys.modules if m.split('.')[0] in ('jax', 's2v_tpu')]\n    raise")
    proc = subprocess.Popen([sys.executable, "-c", code, "--pretrained_model_name_or_path", snap,
                             "--checkpoint_path", lora, "--socket", sock, "--ready_file", str(ready),
                             "--device", "cpu", "--warmup", json.dumps(GEO)],
                            env=env, cwd=str(tmp_path), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        for _ in range(1200):
            if ready.exists() or proc.poll() is not None:
                break
            time.sleep(0.1)
        assert ready.exists(), proc.communicate(timeout=10)
        out = str(tmp_path / "served.mp4")
        client = [sys.executable, "-m", "s2v_torch.serve", "--socket", sock, "--request"]
        gen = subprocess.run(client + [json.dumps({"op": "generate", "prompt": "a pig", "ref_img_path": ref,
                                                   "output_path": out, **GEO})],
                             env=env, cwd=str(tmp_path), capture_output=True, text=True, timeout=300)
        assert gen.returncode == 0, gen.stdout + gen.stderr
        assert json.loads(gen.stdout)["outputs"] == [out] and _frames(out)[0] == 9
        stop = subprocess.run(client + ['{"op": "shutdown"}'], env=env, cwd=str(tmp_path), capture_output=True,
                              text=True, timeout=60)
        assert stop.returncode == 0 and json.loads(stop.stdout)["shutdown"] is True
        _, err = proc.communicate(timeout=60)
        assert proc.returncode == 0, err
        assert "warmup done" in err and "daemon stopped" in err
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


def test_jax_daemon_answers_alike(daemon, tiny, tmp_path):
    """The JAX package's daemon on the same snapshot and requests: the same
    statuses and response keys, and a video of the same shape."""
    from s2v_tpu.pipelines.s2v import S2VPipeline as JS2VPipeline
    from s2v_tpu.serving import ServingDaemon as JServingDaemon

    snap, _, ref, root = tiny
    jax_daemon = JServingDaemon(JS2VPipeline.from_pretrained(snap), str(root / "jax.sock"))
    requests = [
        {"op": "ping"},
        {"op": "bogus"},
        {"op": "generate"},
        {"op": "warmup", **GEO},
        {"op": "generate", "prompt": "a pig", "ref_img_path": ref, "seed": 3, **GEO},
        {"op": "stats"},
    ]
    for i, req in enumerate(requests):
        out = {"output_path": str(tmp_path / f"{i}.mp4")} if "prompt" in req else {}
        mine = daemon.handle({**req, **out})
        theirs = jax_daemon.handle({**req, **({"output_path": str(tmp_path / f"{i}_jax.mp4")} if out else {})})
        assert mine["status"] == theirs["status"] and sorted(mine) == sorted(theirs), (req, mine, theirs)
        if "shape" in theirs:
            assert mine["shape"] == theirs["shape"]
        if "outputs" in theirs:
            assert _frames(mine["outputs"][0])[0] == _frames(theirs["outputs"][0])[0] == 9
