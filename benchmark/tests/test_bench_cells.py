"""The benchmark's runs on the CPU at tiny sizes: each entry against the
plain reference (fp32 configurations, so the two agree to rounding), the
control, and the faults a cell can have, each of which the check has to
catch.  The harness's look for a CUDA device is skipped: ``run_cell`` is
driven on the CPU."""

from __future__ import annotations

import pytest
import torch

from benchmark.harness import Cell, run_cell
from benchmark.tests.tiny import TINY_CELLS, TINY_TRAFFIC, make_checkout

SEED = 2**31 + 77  # above 32 signed bits, as the driver's are


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    return make_checkout(tmp_path_factory.mktemp("bench"))


def run(checkout, cell, control=False, trace=False, seed=SEED):
    return run_cell(Cell(checkout, cell, checkout / "benchmark"), seed, 0.05, trace, torch.device("cpu"),
                    control=control, log=lambda line: None)


@pytest.mark.parametrize("cell", sorted(TINY_CELLS))
def test_entry_agrees_with_the_plain_reference(checkout, cell):
    r = run(checkout, cell)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert list(r)[-1] == "checks"
    for name, c in r["checks"].items():
        assert c["value"] <= c["limit"], name


@pytest.mark.parametrize("cell", sorted(TINY_CELLS))
def test_control_fails_the_check(checkout, cell):
    """The reference one precision lower (fp8), in the program's place: the run's own `correct` is false."""
    r = run(checkout, cell, control=True)
    assert not r["correct"], r["checks"]
    assert any(c["value"] > c["limit"] for c in r["checks"].values()), r["checks"]


def _broken_ddim_unchanged(monkeypatch):
    import s2v_torch.pipelines.denoise as denoise

    monkeypatch.setattr(denoise, "ddim_step", lambda out, sample, *a, **k: (sample, sample))


def _broken_ddim_frame(monkeypatch):
    import s2v_torch.pipelines.denoise as denoise

    real = denoise.ddim_step

    def altered(*a, **k):
        prev, x0 = real(*a, **k)
        prev = prev.clone()
        prev[:, 0] = torch.randn_like(prev[:, 0])  # one frame of the answer altered where it is produced
        return prev, x0

    monkeypatch.setattr(denoise, "ddim_step", altered)


def _broken_half_batch(monkeypatch):
    import s2v_torch.pipelines.denoise as denoise

    real = denoise.transformer_forward

    def cond_only(*a, **k):
        out = real(*a, **k)
        return torch.cat([out[1:], out[1:]]) if out.shape[0] == 2 else out  # the uncond half left out

    monkeypatch.setattr(denoise, "transformer_forward", cond_only)


def _broken_optimizer_unchanged(monkeypatch):
    from s2v_torch.training.optim import Optimizer

    monkeypatch.setattr(Optimizer, "step", lambda self, params, grads, state: None)


def _broken_gradient(monkeypatch):
    from s2v_torch.training.optim import Optimizer

    real = Optimizer.step

    def altered(self, params, grads, state):
        grads = list(grads)
        grads[-1] = torch.zeros_like(grads[-1])  # one leaf's gradient lost where it is produced
        return real(self, params, grads, state)

    monkeypatch.setattr(Optimizer, "step", altered)


def _broken_window_step(monkeypatch):
    """Set-up's steps sound, the window's steps leaving the adapters unchanged."""
    from s2v_torch.training.optim import Optimizer

    real, calls = Optimizer.step, []

    def later_unchanged(self, params, grads, state):
        calls.append(1)
        return real(self, params, grads, state) if len(calls) <= TINY_TRAFFIC["tiny-lora"]["setup_steps"] else None

    monkeypatch.setattr(Optimizer, "step", later_unchanged)


def _broken_decode_frame(monkeypatch):
    import s2v_torch.pipelines.s2v as s2v

    real = s2v.vae_decode

    def altered(*a, **k):
        out = real(*a, **k).clone()
        out[:, 0] = 0.0
        return out

    monkeypatch.setattr(s2v, "vae_decode", altered)


FAULTS = [
    ("tiny-5b-generate", _broken_ddim_unchanged),
    ("tiny-5b-generate", _broken_ddim_frame),
    ("tiny-5b-generate", _broken_half_batch),
    ("tiny-2b-generate", _broken_ddim_frame),
    ("tiny-5b-lora-train", _broken_optimizer_unchanged),
    ("tiny-5b-lora-train", _broken_gradient),
    ("tiny-5b-lora-train", _broken_window_step),
    ("tiny-5b-decode", _broken_decode_frame),
]


@pytest.mark.parametrize("cell,fault", FAULTS, ids=[f"{c}-{f.__name__.strip('_')}" for c, f in FAULTS])
def test_a_broken_timed_path_is_not_correct(checkout, cell, fault, monkeypatch):
    fault(monkeypatch)
    r = run(checkout, cell)
    assert not r["correct"], r["checks"]


def test_traced_run_names_the_window_and_its_gaps(checkout):
    r = run(checkout, "tiny-5b-generate", trace=True)
    dev = r["device"]
    assert dev["window_s"] > 0 and dev["busy_s"] == 0.0  # no device on the CPU: nothing to read
    assert r["metrics"] == {}  # each reader found nothing and returned None
    assert r["breakdown"]["idle_gaps"][0][0].startswith("bench.")


def test_same_seed_same_inputs(checkout):
    cell = Cell(checkout, "tiny-5b-generate", checkout / "benchmark")
    a, b = cell.entry(SEED, torch.device("cpu")), cell.entry(SEED, torch.device("cpu"))
    for x, y in zip(a.inputs(0), b.inputs(0)):
        assert torch.equal(x, y)
    assert not torch.equal(a.inputs(0)[2], cell.entry(SEED + 1, torch.device("cpu")).inputs(0)[2])


def test_a_clip_start_weighs_one_step_of_a_clip(checkout):
    """denoise_step_s: the window's clip-start steps weigh 1 in num_inference_steps, the other steps the rest."""
    entry = Cell(checkout, "tiny-5b-generate", checkout / "benchmark").entry(SEED, torch.device("cpu"))
    n = entry.traffic["num_inference_steps"]
    entry.clip_starts = [True, False, False, False, True, False]
    durations = [3.0, 1.0, 1.0, 1.0, 5.0, 1.0]
    assert entry.unit_seconds(durations) == pytest.approx((4.0 + (n - 1) * 1.0) / n)
    entry.clip_starts = [True]
    assert entry.unit_seconds([3.0]) == 3.0  # no step of the other kind: the plain mean
