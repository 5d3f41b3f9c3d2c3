"""The port's spans (``s2v_torch/utils/logging.py::phase``) on the CPU: with
no profiler a span records nothing and enters no ``record_function``;
under ``torch.profiler`` spans nest, their host stamps agree with Kineto's
own events, a tiny generate and a tiny LoRA step record the spans the
benchmark's readers read, remat's recompute fires the block spans again
inside the backward, the gradients are the same bits with the profiler on
and off, and the CLI prints the spans line under ``--profile_dir``."""

import gc
import json
import statistics

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from s2v_torch import S2VPipeline, TransformerConfig, VAEConfig
from s2v_torch.config import SchedulerConfig
from s2v_torch.models.transformer import init_transformer_params_random
from s2v_torch.models.vae import init_vae_params_random
from s2v_torch.schedulers.ddim import compute_alphas_cumprod
from s2v_torch.training import lora
from s2v_torch.utils import logging as slog
from s2v_torch.utils.logging import clear_spans, phase, span_records, span_summary

STEPS = 2


def _profiled():
    clear_spans()
    return profile(activities=[ProfilerActivity.CPU])


def _tiny_pipe(layers=2):
    tcfg = TransformerConfig.tiny(num_layers=layers)
    vcfg = VAEConfig.tiny(latent_channels=4, sample_height=64, sample_width=64)
    pipe = S2VPipeline(transformer_params=init_transformer_params_random(tcfg, device="cpu"), transformer_cfg=tcfg,
                       vae_params=init_vae_params_random(vcfg, device="cpu"), vae_cfg=vcfg, device="cpu")
    pipe.set_attention("flash")  # B1's plain version in its bounded mode, with its guard
    return pipe


def _generate(pipe, **kw):
    g = torch.Generator().manual_seed(0)
    return pipe.generate(prompt_embeds=torch.randn(2, 16, 32, generator=g),
                         ref_latents=torch.randn(1, 1, 4, 4, 4, generator=g), height=32, width=32, num_frames=9,
                         num_inference_steps=STEPS, output_type="latent", seed=1, **kw)


def _under(recs, i, name):
    """Whether span ``i`` lies under a span named ``name``."""
    i = recs[i].parent
    while i is not None:
        if recs[i].name == name:
            return True
        i = recs[i].parent
    return False


def test_no_profiler_records_nothing_and_enters_no_record_function(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function entered with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    clear_spans()
    pipe = _tiny_pipe()
    out = _generate(pipe)
    assert out.shape == (1, 3, 4, 4, 4) and span_records() == []
    assert phase("s2v.adaln") is phase("s2v.gate")  # one shared no-op: no clock, no event, no record
    assert len(pipe.timings["denoise_step_s"]) == STEPS


def test_spans_nest_under_their_parents():
    with _profiled():
        with phase("s2v.step", step=7):
            with phase("s2v.adaln"):
                torch.ones(4).add_(1)
            with phase("s2v.gate"):
                with phase("s2v.sync.b1_guard"):
                    pass
        with phase("s2v.decode"):
            pass
    recs = span_records()
    assert [(r.name, r.parent) for r in recs] == [("s2v.step", None), ("s2v.adaln", 0), ("s2v.gate", 0),
                                                  ("s2v.sync.b1_guard", 2), ("s2v.decode", None)]
    assert recs[0].attrs == {"step": 7} and all(r.device_ms is None for r in recs)  # no CUDA events on the CPU
    for r in recs:
        assert r.start_ns <= r.end_ns
        if r.parent is not None:
            p = recs[r.parent]
            assert p.start_ns <= r.start_ns and r.end_ns <= p.end_ns


def test_spans_leave_no_object_for_the_collector():
    """A span under a profiler keeps no object that Python's collector
    counts, so a traced window collects garbage as an untraced one does."""
    with _profiled():
        with phase("s2v.step", step=0):
            pass
        gc.disable()
        try:
            before = gc.get_count()[0]
            for _ in range(1000):
                with phase("s2v.adaln"):
                    with phase("s2v.sync.b1_guard"):
                        pass
            kept = gc.get_count()[0] - before
        finally:
            gc.enable()
    assert len(span_records()) == 2001 and kept < 20


def test_stamps_agree_with_kinetos_events():
    """Median gap of start and end stamps over 100 warm spans <= 0.2 ms."""
    with _profiled() as prof:
        for i in range(120):
            with phase(f"s2v.stamp{i}"):
                torch.ones(8).mul_(2)
    events = {e.name(): e for e in prof.profiler.kineto_results.events() if e.name().startswith("s2v.stamp")}
    gaps = []
    for r in span_records()[20:]:
        e = events[r.name]
        gaps += [abs(e.start_ns() - r.start_ns), abs(e.start_ns() + e.duration_ns() - r.end_ns)]
    assert len(gaps) == 200 and statistics.median(gaps) <= 0.2e6


def test_generate_records_the_block_spans_of_each_step():
    pipe = _tiny_pipe()
    layers = pipe.transformer_cfg.num_layers
    with _profiled():
        _generate(pipe)
    recs = span_records()
    names = [r.name for r in recs]
    assert names.count("s2v.prologue") == 1 and recs[names.index("s2v.prologue")].attrs == {
        "steps": STEPS, "tokens_text": 16, "tokens_ref": 4, "tokens_video": 12, "pad_frames": 0}
    for child in ("s2v.prologue.rope", "s2v.prologue.pos_embedding"):
        assert _under(recs, names.index(child), "s2v.prologue")
    steps = [i for i, r in enumerate(recs) if r.name == "s2v.step"]
    assert [recs[i].attrs["step"] for i in steps] == list(range(STEPS))
    want = {"s2v.adaln": 2, "s2v.qk_rope": 1, "s2v.attention": 1, "s2v.gate": 2, "s2v.gelu": 1,
            "s2v.sync.b1_guard": 1}
    for s in steps:
        got = {n: sum(1 for i, r in enumerate(recs) if r.name == n and r.parent is not None
                      and _under(recs, i, "s2v.step") and _step_of(recs, i) == s) for n in want}
        assert got == {n: k * layers for n, k in want.items()}
        once = {n: sum(1 for i, r in enumerate(recs) if r.name == n and _step_of(recs, i) == s)
                for n in ("s2v.patch_embed", "s2v.unpatchify")}
        assert once == {"s2v.patch_embed": 1, "s2v.unpatchify": 1}  # one batched CFG forward a step
        assert sum(1 for i, r in enumerate(recs) if r.name == "s2v.cfg_ddim" and _step_of(recs, i) == s) >= 1
    guards = [i for i, r in enumerate(recs) if r.name == "s2v.sync.b1_guard"]
    assert all(_under(recs, i, "s2v.attention") for i in guards)
    assert names.count("s2v.denoise") == 1 and len(pipe.timings["denoise_step_s"]) == STEPS


def _step_of(recs, i):
    while i is not None and recs[i].name != "s2v.step":
        i = recs[i].parent
    return i


def _lora_setup(layers=4):
    cfg = TransformerConfig.tiny(num_layers=layers)
    params = init_transformer_params_random(cfg, seed=3, device="cpu", scale=0.1)
    spec = lora.LoRASpec(rank=4, alpha=8.0)
    tree = lora.init_lora_params(torch.Generator().manual_seed(1), params, spec)
    g = torch.Generator().manual_seed(2)
    for ab in tree.values():  # B = 0 would give A no gradient
        ab["b"] = 0.1 * torch.randn(ab["b"].shape, generator=g)
    c = cfg.in_channels
    batch = {"video_latents": torch.randn(1, 2, 8, 8, c, generator=g),
             "ref_latents": torch.randn(1, 1, 8, 8, c, generator=g),
             "text_embeds": torch.randn(1, cfg.max_text_seq_length, cfg.text_embed_dim, generator=g)}
    draws = dict(timesteps=torch.tensor([321]), noise=torch.randn(1, 2, 8, 8, c, generator=g))
    return cfg, params, spec, tree, batch, draws


def test_lora_step_records_forward_backward_and_optimizer():
    cfg, params, spec, tree, batch, draws = _lora_setup()
    init_opt, step = lora.make_lora_train_step(params, cfg, spec, attention_backend="flash", remat="full")
    opt = init_opt(tree)
    with _profiled():
        step(tree, opt, batch, **draws)
    recs = span_records()
    names = [r.name for r in recs]
    parts = ["s2v.train.forward", "s2v.train.backward", "s2v.train.optimizer"]
    assert [n for n in names if n.startswith("s2v.train.")] == ["s2v.train.step"] + parts
    assert all(recs[names.index(p)].parent == names.index("s2v.train.step") for p in parts)
    # remat's recompute runs each block's forward again inside the backward
    backward = [i for i, r in enumerate(recs) if r.name == "s2v.adaln" and _under(recs, i, "s2v.train.backward")]
    forward = [i for i, r in enumerate(recs) if r.name == "s2v.adaln" and _under(recs, i, "s2v.train.forward")]
    assert len(forward) == 2 * cfg.num_layers and len(backward) >= cfg.num_layers
    assert span_summary()["s2v.train.step"][0] == 1


@pytest.mark.parametrize("remat", ["full", "dots", "seg2"])
def test_gradients_are_the_same_bits_with_the_profiler_on_and_off(remat):
    cfg, params, spec, tree, batch, draws = _lora_setup()
    alphas = torch.as_tensor(compute_alphas_cumprod(SchedulerConfig()))

    def grads():
        leaves = lora.lora_leaves(tree)
        for x in leaves:
            x.requires_grad_(True)
        loss = lora.lora_loss_fn(tree, params, cfg, spec, batch, alphas, attention_backend="flash", remat=remat,
                                 **draws)
        return [loss] + list(torch.autograd.grad(loss, leaves))

    off = grads()
    with _profiled():
        on = grads()
    assert sum(r.name == "s2v.adaln" for r in span_records()) > 2 * cfg.num_layers  # the recompute's too
    assert all(torch.equal(a, b) for a, b in zip(off, on))


def test_cli_prints_the_spans_line(tmp_path, capsys):
    from PIL import Image

    from _torch_parity import write_tiny_snapshot
    from s2v_torch import cli

    snap, lora_dir = write_tiny_snapshot(tmp_path)
    ref = str(tmp_path / "ref.png")
    Image.fromarray((np.random.RandomState(0).rand(32, 32, 3) * 255).astype("uint8")).save(ref)
    cli.main(["--pretrained_model_name_or_path", snap, "--checkpoint_path", lora_dir, "--ref_img_path", ref,
              "--prompt", "<cls> a pig", "--height", "32", "--width", "32", "--max_num_frames", "9",
              "--num_inference_steps", "2", "--output_dir", str(tmp_path / "out"), "--device", "cpu",
              "--profile_dir", str(tmp_path / "prof")])
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("[s2v_torch] spans ")]
    assert len(lines) == 1
    spans = json.loads(lines[0][len("[s2v_torch] spans "):])
    for name in ("s2v.prologue", "s2v.encode_prompt", "s2v.encode_ref", "s2v.denoise", "s2v.step", "s2v.adaln",
                 "s2v.decode", "s2v.decode.vae", "s2v.decode.to_host"):
        calls, host_ms, device_ms, self_ms = spans[name]
        assert calls >= 1 and host_ms >= 0 and device_ms is None and self_ms is None
    assert spans["s2v.step"][0] == 2


def test_summary_self_time_is_device_time_less_the_childrens():
    rec = slog.SpanRecord
    a, b, c = rec("s2v.step", None, 0, 100, device_ms=10.0), rec("s2v.adaln", 0, 10, 20, device_ms=3.0), \
        rec("s2v.gate", 0, 30, 40, device_ms=2.5)
    got = span_summary([a, b, c])
    assert got["s2v.step"] == [1, 100 / 1e6, 10.0, 4.5] and got["s2v.gate"] == [1, 10 / 1e6, 2.5, 2.5]
    assert list(span_summary([a, b, c], window=(5, 25))) == ["s2v.adaln"]
