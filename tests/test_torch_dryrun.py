"""``python -m s2v_torch.dryrun --ranks 4`` (ROADMAP A.9.5): the port's
multi-rank dry run, the sharded product paths of
``__graft_entry__.py::dryrun_multichip`` on 4 gloo ranks on the CPU, exits
0 with one OK line a phase, well inside 120 s; and the tiny-config
fixtures of ``s2v_torch/testing.py`` against ``s2v_tpu/testing.py``'s."""

import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]


def test_dryrun_at_four_ranks_runs_every_phase():
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    t0 = time.monotonic()
    proc = subprocess.run([sys.executable, "-m", "s2v_torch.dryrun", "--ranks", "4", "--timeout", "110"],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    seconds = time.monotonic() - t0
    ok = [ln for ln in proc.stdout.splitlines() if ln.startswith("dryrun: [") and " OK (" in ln]
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert len(ok) == 8, proc.stdout
    assert "dryrun: 4 ranks OK" in proc.stdout
    assert seconds < 120


@pytest.mark.parametrize("ranks,want", [(1, {"model": 1}), (2, {"data": 2, "model": 1}), (4, {"data": 2, "model": 2}),
                                        (8, {"data": 2, "model": 4}), (6, {"data": 3, "model": 2})])
def test_dp_tp_mesh_of_the_dry_run(ranks, want):
    """Phase 1's data x model dims: JAX's {data 2, model n/2} while the tiny
    DiT's 4 heads split, at least 2 data ranks otherwise."""
    from s2v_torch.dryrun import _dp_tp

    assert _dp_tp(ranks) == want


def test_tiny_fixtures_match_jax_testing():
    """The same config, geometry and generate arguments as JAX's fixtures
    (the draws differ: each package seeds its own generator)."""

    from s2v_torch.testing import tiny_generate_kwargs, tiny_pipeline
    from s2v_tpu.testing import tiny_generate_kwargs as j_kwargs
    from s2v_tpu.testing import tiny_pipeline as j_pipeline

    for overrides in ({}, {"num_attention_heads": 8}):
        pipe, jpipe = tiny_pipeline(device="cpu", **overrides), j_pipeline(**overrides)
        assert pipe.attention_backend == "plain" and jpipe.attention_backend == "xla"
        cfg, jcfg = pipe.transformer_cfg, jpipe.transformer_cfg
        for name in ("num_attention_heads", "attention_head_dim", "num_layers", "in_channels", "patch_size",
                     "max_text_seq_length", "text_embed_dim"):
            assert getattr(cfg, name) == getattr(jcfg, name), name
        kw, jkw = tiny_generate_kwargs(pipe), j_kwargs(jpipe)
        assert sorted(kw) == sorted(jkw)
        for name in ("height", "width", "num_frames", "num_inference_steps", "guidance_scale", "seed", "output_type"):
            assert kw[name] == jkw[name], name
        for name in ("prompt_embeds", "ref_latents"):
            assert tuple(kw[name].shape) == tuple(np.asarray(jkw[name]).shape), name
        assert tiny_generate_kwargs(pipe, num_frames=9, output_type="latent")["num_frames"] == 9
