"""The 1.5-5b-generate and 5b-generate-windowed entries on the CPU at tiny
sizes, through ``harness.run_cell`` as the real cells run: each against its
plain reference (``reference/dit_pt.py``, ``reference/dit_band.py``; fp32
configurations, so the two agree to rounding), the fp8 control, and the
faults their checks have to catch: a band that leaks one frame, the
temporal patch's features in another order, a token counter that differs.
The tiny files are added here, beside ``tiny.py``'s, as new files."""

from __future__ import annotations

import copy
import json

import pytest
import torch

from benchmark import band
from benchmark.harness import Cell, run_cell
from benchmark.tests.tiny import TINY_5B, make_checkout, write

SEED = 2**31 + 91

TINY_15 = copy.deepcopy(TINY_5B)
TINY_15.update(name="tiny-1.5-5b", source="https://huggingface.co/THUDM/CogVideoX1.5-5B")
TINY_15["transformer"].update(patch_size_t=2, patch_bias=False, sample_frames=81, sample_height=300, sample_width=300)
TINY_15["vae"]["invert_scale_latents"] = True

TRAFFIC = {
    # 9 frames: 3 latent frames, padded to 4, 2 temporal patches of 4 x 3
    "tiny-generate-pt": {"entry": "generate_pt", "height": 64, "width": 48, "num_frames": 9, "num_inference_steps": 4,
                         "guidance_scale": 6.0, "cfg_mode": "batched", "attention_backend": "auto"},
    # 17 frames: 5 latent frames, a window of 3 around each
    "tiny-generate-windowed": {"entry": "generate_windowed", "height": 64, "width": 48, "num_frames": 17,
                               "num_inference_steps": 4, "guidance_scale": 6.0, "cfg_mode": "batched",
                               "attention_backend": "windowed", "window": 1},
}
CELLS = {
    "tiny-1.5-5b-generate": ("tiny-1.5-5b", "tiny-generate-pt", {"step_rel_l1": 1e-4, "token_gap": 0}),
    "tiny-5b-generate-windowed": ("tiny-5b", "tiny-generate-windowed", {"step_rel_l1": 1e-4}),
}


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    root = make_checkout(tmp_path_factory.mktemp("bench"))
    write(root / "benchmark" / "configs" / "tiny-1.5-5b.json", TINY_15)
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": TINY_15["name"], "source": TINY_15["source"],
                            "file": "benchmark/configs/tiny-1.5-5b.json", "reduced": [], "why": "a CPU test"})
    for name, traffic in TRAFFIC.items():
        write(root / "benchmark" / "traffic" / f"{name}.json", traffic)
    for cell, (config, traffic, lim) in CELLS.items():
        write(root / "benchmark" / "limits" / f"{cell}.json", lim)
        spec["workloads"].append({"name": cell, "config": config, "traffic": traffic, "chips": 1, "why": "a CPU test"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m and "5b-generate-windowed" in m["workloads"]:
            m["workloads"].append("tiny-5b-generate-windowed")
        if "workloads" in m and "1.5-5b-generate" in m["workloads"]:
            m["workloads"].append("tiny-1.5-5b-generate")
    write(root / "BENCHMARK.json", spec)
    return root


def run(checkout, cell, control=False, trace=False):
    return run_cell(Cell(checkout, cell, checkout / "benchmark"), SEED, 0.05, trace, torch.device("cpu"),
                    control=control, log=lambda line: None)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_entry_agrees_with_its_plain_reference(checkout, cell):
    r = run(checkout, cell)
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert 0 < r["checks"]["step_rel_l1"]["value"] <= CELLS[cell][2]["step_rel_l1"]


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_control_fails_the_check(checkout, cell):
    r = run(checkout, cell, control=True)
    assert not r["correct"] and r["checks"]["step_rel_l1"]["value"] > r["checks"]["step_rel_l1"]["limit"]


def _leaky_band(monkeypatch):
    """Each video query of the first frame also sees the frame past its window."""
    import s2v_torch.ops.attention as attention
    from s2v_torch.kernels.banded_attention import band_geometry, band_mask

    def leaky(q, k, v, global_len, tpf, w):
        s, d = q.shape[1], q.shape[-1]
        geo = band_geometry(s, global_len, tpf, w)
        mask = band_mask(geo, torch.arange(s), s).clone()
        past = global_len + (geo.window_start(0) + geo.span) * tpf
        mask[global_len:global_len + tpf, past:past + tpf] = True
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / d ** 0.5
        p = logits.masked_fill(~mask, float("-inf")).softmax(-1)
        return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)

    monkeypatch.setattr(attention, "banded_attention_trainable", leaky)


def _swapped_patch_features(monkeypatch):
    """The temporal patch's features in (pₜ, c, ph, pw) order, not (c, pₜ, ph, pw)."""
    import torch.nn.functional as F

    import s2v_torch.models.transformer as transformer

    real = transformer.patchify_video

    def swapped(x, weight, bias, p, pt=None):
        if pt is None:
            return real(x, weight, bias, p)
        b, f, h, w, c = x.shape
        x = x.reshape(b, f // pt, pt, h // p, p, w // p, p, c).permute(0, 1, 3, 5, 2, 7, 4, 6)
        return F.linear(x.reshape(b, -1, c * pt * p * p), weight, bias)

    monkeypatch.setattr(transformer, "patchify_video", swapped)


def _miscounted_tokens(monkeypatch):
    """The program reports a video token count other than the one it ran."""
    import s2v_torch.pipelines.s2v as s2v

    real = s2v.token_grid
    monkeypatch.setattr(s2v, "token_grid", lambda *a: (real(*a)[0] + 1, real(*a)[1]))


FAULTS = [
    ("tiny-5b-generate-windowed", _leaky_band),
    ("tiny-1.5-5b-generate", _swapped_patch_features),
    ("tiny-1.5-5b-generate", _miscounted_tokens),
]


@pytest.mark.parametrize("cell,fault", FAULTS, ids=[f"{c}-{f.__name__.strip('_')}" for c, f in FAULTS])
def test_a_fault_is_not_correct(checkout, cell, fault, monkeypatch):
    fault(monkeypatch)
    r = run(checkout, cell)
    assert not r["correct"], r["checks"]


def test_the_programs_token_counters_agree_with_the_entrys(checkout):
    cell = Cell(checkout, "tiny-1.5-5b-generate", checkout / "benchmark")
    entry = cell.entry(SEED, torch.device("cpu"))
    assert entry.tokens == {"text": 8, "ref": 12, "video": 24} and entry.pad_frames == 1
    assert entry.lat_shape == (1, 4, 8, 6, 4) and entry.b1_shape() == (2, 44, 2, 16)
    r = run(checkout, "tiny-1.5-5b-generate", trace=True)  # the traced run reads the prologue's attributes too
    assert r["correct"] and r["checks"]["token_gap"]["value"] == 0


def test_a_port_without_temporal_patches_fails_at_setup(checkout, monkeypatch):
    """A parent without ``patch_size_t`` refuses the cell at once, before any weight is made."""
    import dataclasses

    import s2v_torch.config as config

    fields = [f for f in dataclasses.fields(config.TransformerConfig) if f.name != "patch_size_t"]
    monkeypatch.setattr(dataclasses, "fields", lambda cls: fields)
    entry = Cell(checkout, "tiny-1.5-5b-generate", checkout / "benchmark").entry(SEED, torch.device("cpu"))
    with pytest.raises(SystemExit, match="patch_size_t"):
        entry.setup()


def test_band_counts_by_hand():
    """The 5b geometry: G = 226 + 1,350, 13 frames of 1,350, w = 2 (5 frames),
    B = 2, H = 48, d = 64."""
    b4, glob = band.attention_flops(2, 48, 64, 1576, 1350, 13, 2)
    assert band.video_queries(13, 1350) == 17550 and band.band_keys(1576, 1350, 13, 2) == 8326
    assert b4 == 4 * 2 * 48 * 64 * 17550 * 8326 and round(b4 / 1e10) == 359  # 3.59e12
    assert glob == 4 * 2 * 48 * 64 * 1576 * 19126 and round(glob / 1e9) == 741  # 7.41e11
    # bytes: q and o of the video queries, k and v of all 19,126 keys in bf16, the lse row
    assert band.b4_bytes(2, 48, 64, 1576, 1350, 13, 2) == 2 * 48 * 64 * 2 * (2 * 17550 + 2 * 19126) + 2 * 48 * 17550 * 4
    assert band.band_keys(1576, 1350, 3, 2) == 1576 + 3 * 1350  # a clip shorter than the window: every frame
