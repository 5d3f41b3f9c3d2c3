"""The port's CLI (``python -m s2v_torch.cli``) against the JAX package's:
the same flags and defaults, a ``NotImplementedError`` naming its ROADMAP
item for every flag whose path is not ported, and end-to-end runs on a
tiny snapshot with its LoRA on the CPU that write a 9-frame, 8-fps mp4 (at
the defaults, and once per denoise flag)."""

import argparse
import os
import subprocess
import sys

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from _torch_parity import write_tiny_snapshot
from s2v_tpu import cli as jcli
from s2v_torch import cli
from s2v_torch.cli_utils import BACKEND_NAMES, SEQ_BACKEND_NAMES
from s2v_torch.ops.attention import ATTENTION_BACKENDS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _parser_actions(get_args):
    """The parser behind ``get_args`` (captured from ``parse_args``), as
    {dest: (option strings, default, choices, nargs, action kind, type name)}."""
    seen = {}
    real = argparse.ArgumentParser.parse_args

    def capture(self, args=None, namespace=None):
        seen["parser"] = self
        return real(self, args, namespace)

    argparse.ArgumentParser.parse_args = capture
    try:
        get_args([])
    finally:
        argparse.ArgumentParser.parse_args = real
    return {a.dest: (tuple(a.option_strings), a.default, tuple(a.choices) if a.choices else None, a.nargs,
                     type(a).__name__, getattr(a.type, "__name__", None))
            for a in seen["parser"]._actions if a.dest != "help"}


def test_get_args_has_every_flag_and_default_of_jax():
    port, ref = _parser_actions(cli.get_args), _parser_actions(jcli.get_args)
    assert set(port) - set(ref) == {"device"}  # the port's own flag
    for dest, want in ref.items():
        assert port[dest] == want, dest
    assert cli.get_args([]).device == "cuda"


# flags -> (the error, what it says), each raised before anything loads: a
# mesh spec that does not parse, T5 on the mesh without one, and the
# sequence-parallel backends without --mesh (every mesh dim is ported)
UNPORTED = {
    "mesh": (["--mesh", "xp2"], ValueError, "bad mesh spec 'xp2'"),
    "t5_on_mesh": (["--text_encoder_device", "mesh"], ValueError, "--text_encoder_device mesh needs --mesh"),
    **{f"backend_{b}": (["--attention_backend", b], ValueError, "needs --mesh") for b in SEQ_BACKEND_NAMES},
}


@pytest.mark.parametrize("case", sorted(UNPORTED))
def test_unported_flag_raises_naming_its_roadmap_item(case, tmp_path):
    flags, error, says = UNPORTED[case]
    argv = ["--ref_img_path", "x.png", "--output_dir", str(tmp_path / "out"), "--device", "cpu", *flags]
    with pytest.raises(error, match=says):
        cli.main(argv)
    assert not (tmp_path / "out").exists()  # raised before anything was loaded or written


def test_every_jax_backend_name_is_mapped_or_unported():
    assert set(BACKEND_NAMES) == set(cli.ATTENTION_BACKEND_CHOICES)
    assert set(SEQ_BACKEND_NAMES) <= set(BACKEND_NAMES)
    assert set(BACKEND_NAMES.values()) <= set(ATTENTION_BACKENDS)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    snap, lora = write_tiny_snapshot(root)
    ref = str(root / "ref.png")
    Image.fromarray((np.random.RandomState(0).rand(32, 32, 3) * 255).astype("uint8")).save(ref)
    return snap, lora, ref


def _argv(tiny, out, *extra):
    snap, lora, ref = tiny
    return ["--pretrained_model_name_or_path", snap, "--checkpoint_path", lora, "--ref_img_path", ref,
            "--prompt", "<cls> a pig walking", "--height", "32", "--width", "32", "--max_num_frames", "9",
            "--num_inference_steps", "2", "--output_dir", str(out), "--device", "cpu", *extra]


def test_main_on_the_cpu_writes_a_9_frame_8_fps_mp4(tiny, tmp_path, capsys):
    cli.main(_argv(tiny, tmp_path / "out", "--profile_dir", str(tmp_path / "prof"),
                   "--save_merged_dir", str(tmp_path / "merged")))
    printed = capsys.readouterr().out
    path = str(tmp_path / "out" / "output.mp4")
    assert f"[s2v_torch] wrote {path}" in printed and "Inference completed" in printed
    assert "[s2v_torch] generated (1, 9, 32, 32, 3)" in printed and "[s2v_torch] stage seconds" in printed
    assert os.path.getsize(path) > 0
    cap = cv2.VideoCapture(path)
    assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == 9
    assert round(cap.get(cv2.CAP_PROP_FPS)) == 8
    cap.release()
    assert os.path.getsize(tmp_path / "prof" / "trace.json") > 0
    assert os.path.exists(tmp_path / "merged" / "transformer" / "diffusion_pytorch_model.safetensors")


DENOISE_FLAGS = {
    "use_dpm": ["--use_dpm"],
    "adaptive": ["--adaptive_threshold", "0.05", "--num_inference_steps", "4"],
    "cfg_skip": ["--cfg_skip_threshold", "0.02", "--use_dynamic_cfg"],
    "segments": ["--segment_steps", "1"],
    "progress": ["--progress"],
    "backend_chunked": ["--attention_backend", "chunked"],
}


@pytest.mark.parametrize("case", sorted(DENOISE_FLAGS))
def test_main_on_the_cpu_with_denoise_flags(case, tiny, tmp_path, capsys):
    """Each denoise flag, and the chunked backend, runs on the tiny snapshot to its clip."""
    cli.main(_argv(tiny, tmp_path / "out", *DENOISE_FLAGS[case]))
    captured = capsys.readouterr()
    path = str(tmp_path / "out" / "output.mp4")
    assert f"[s2v_torch] wrote {path}" in captured.out and "Inference completed" in captured.out
    cap = cv2.VideoCapture(path)
    assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == 9
    cap.release()
    if case == "segments":
        assert "[s2v_torch] denoise 1/2 steps (+" in captured.out and "[s2v_torch] denoise 2/2 steps (+" in captured.out
    if case == "progress":
        assert "\r[s2v_torch] denoise step 2/2\n" in captured.err
    if case == "cfg_skip":
        assert "cfg-skip: uncond forward skipped on 1/2 steps" in captured.err


def test_main_as_a_module_with_jax_backend_names(tiny, tmp_path):
    """``python -m s2v_torch.cli`` in a fresh process that never imports JAX,
    with the JAX names of the int8 path (pallas_int8 = flash_int8, whose
    plain version runs on the CPU)."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    code = ("import runpy, sys; before = set(sys.modules); sys.argv = ['s2v_torch.cli'] + sys.argv[1:]; "
            "runpy.run_module('s2v_torch.cli', run_name='__main__'); "
            "assert not [m for m in set(sys.modules) - before if m.split('.')[0] in ('jax', 's2v_tpu')]")
    argv = _argv(tiny, tmp_path / "out", "--quantize_int8", "--attention_backend", "pallas_int8", "--dtype", "float32")
    proc = subprocess.run([sys.executable, "-c", code, *argv], env=env, capture_output=True, text=True, timeout=300,
                          cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert os.path.getsize(tmp_path / "out" / "output.mp4") > 0


def test_main_without_a_card_raises_unless_asked_for_the_cpu(tiny, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = _argv(tiny, tmp_path / "out")[:-2]  # no --device: cuda
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(argv)


@pytest.mark.parametrize("case", ["t2v", "disentangled"])
def test_main_on_the_cpu_t2v_and_disentangled(case, tiny, tmp_path, capsys):
    """``--pipeline t2v`` (no subject image needed) and
    ``--disentangled_modulation`` run on the tiny snapshot to their clips,
    and the clip's latents are JAX's: the same flags through the JAX CLI's
    model assembly give the same frames."""
    import jax
    import jax.numpy as jnp

    from s2v_tpu.pipelines.s2v import S2VPipeline as JS2VPipeline
    from s2v_tpu.pipelines.variants import generate_t2v as j_generate_t2v
    from s2v_torch.pipelines.s2v import S2VPipeline
    from s2v_torch.pipelines.variants import generate_t2v

    flags = ["--pipeline", "t2v"] if case == "t2v" else ["--disentangled_modulation"]
    argv = _argv(tiny, tmp_path / "out", *flags, "--dtype", "float32")
    if case == "t2v":
        i = argv.index("--ref_img_path")
        argv = argv[:i] + argv[i + 2:]
    cli.main(argv)
    printed = capsys.readouterr().out
    path = str(tmp_path / "out" / "output.mp4")
    assert f"[s2v_torch] wrote {path}" in printed and "[s2v_torch] generated (1, 9, 32, 32, 3)" in printed
    cap = cv2.VideoCapture(path)
    assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == 9
    cap.release()
    if case == "t2v":
        snap, lora, _ = tiny
        jpipe = JS2VPipeline.from_pretrained(snap, lora_checkpoint=lora, dtype=jnp.float32)
        kw = dict(height=32, width=32, num_frames=9, num_inference_steps=2, guidance_scale=6.0, seed=420,
                  output_type="latent")
        want = np.asarray(j_generate_t2v(jpipe, "<cls> a pig walking", **kw))
        pipe = S2VPipeline.from_pretrained(snap, lora_checkpoint=lora, dtype=torch.float32, device="cpu")
        keys = {"latents": jax.random.PRNGKey(420)}
        pipe.variant_noise = lambda name, shape: torch.from_numpy(
            np.array(jax.random.normal(keys[name], tuple(shape), jnp.float32)))
        np.testing.assert_allclose(generate_t2v(pipe, "<cls> a pig walking", **kw).numpy(), want, atol=1e-4,
                                   rtol=1e-4)
    with pytest.raises(SystemExit, match="ref_img_path"):
        cli.main([a for a in _argv(tiny, tmp_path / "out2") if a not in (tiny[2], "--ref_img_path")])
