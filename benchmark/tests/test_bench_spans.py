"""The readers of the program's spans (``benchmark/spans.py`` and its seven
reader files) on a synthetic trace and synthetic span records: a gap that
opens inside a sync span is sync idle; a gap under a clip's prologue is
host idle weighed 1 in the clip's steps; a gap under the caller's callback
or under no program span goes to neither; a span's device ms leave out
the idle inside it; records outside the window are left out; no records,
or no device operation, read None."""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from types import SimpleNamespace
from typing import Optional

import pytest

from benchmark import spans
from benchmark.harness import Cell
from benchmark.tests.tiny import ROOT
from benchmark.trace import Trace

NEW_METRICS = ("adaln_ms.generate", "qk_rope_ms.generate", "gate_ms.generate", "backward_ms.train",
               "optimizer_ms.train", "sync_idle_ms.generate", "sync_idle_ms.train", "host_idle_ms.generate",
               "host_idle_ms.train", "host_idle_ms.decode")


@dataclass
class Rec:
    name: str
    parent: Optional[int]
    start_ns: int
    end_ns: Optional[int]
    device_ms: Optional[float] = None
    attrs: dict = field(default_factory=dict)


def run_of(ops, window, recs, units=1):
    return SimpleNamespace(trace=Trace(ops=ops, window=window), units=units, span_records=recs)


def read(metric, run):
    return Cell(ROOT, "5b-generate").reader(metric)(run)


def test_a_gap_that_opens_inside_a_sync_span_is_sync_idle():
    # kernels 0..100 and 200..300; the host waits in B1's guard from 50 to 150
    recs = [Rec("s2v.step", None, 0, 300), Rec("s2v.attention", 0, 10, 160), Rec("s2v.sync.b1_guard", 1, 50, 150)]
    run = run_of([("k", 0, 100), ("k", 200, 300)], (0, 300), recs, units=2)
    assert read("sync_idle_ms.generate", run) == pytest.approx(100 / 2 / 1e6)  # all of it, though the host left
    assert read("host_idle_ms.generate", run) == 0.0


def test_a_gap_under_the_prologue_is_host_idle_weighed_one_in_the_clips_steps():
    # the gap 100..1100: the caller's callback 50..150, nothing 150..200, the prologue
    # 200..1000 (its sincos table 300..900 inside), nothing after
    recs = [Rec("s2v.callback", None, 50, 150), Rec("s2v.prologue", None, 200, 1000, attrs={"steps": 10}),
            Rec("s2v.prologue.pos_embedding", 1, 300, 900), Rec("s2v.step", None, 1000, 1300),
            Rec("s2v.adaln", 3, 1050, 1150)]
    run = run_of([("k", 0, 100), ("k", 1100, 1200)], (0, 1300), recs, units=4)
    split = spans.idle(run)
    assert split["prologue"] == 800 and split["sync"] == 0 and split["prologue_per_step"] == 80
    # the step's own host time before its first kernel (1000..1100, 1050.. under adaln) counts per unit;
    # the tail 1200..1300 lies under the step
    assert split["host"] == 100 + 100
    assert read("host_idle_ms.generate", run) == pytest.approx((200 / 4 + 80) / 1e6)
    assert read("sync_idle_ms.generate", run) == 0.0


def test_a_gap_outside_program_spans_goes_to_neither():
    recs = [Rec("s2v.step", None, 0, 100), Rec("s2v.callback", None, 100, 150)]
    run = run_of([("k", 0, 100), ("k", 300, 400)], (0, 400), recs)
    assert spans.idle(run) == {"sync": 0.0, "host": 0.0, "prologue": 0.0, "prologue_per_step": 0.0}


def test_records_outside_the_window_are_left_out():
    recs = [Rec("s2v.adaln", None, -50, -10, device_ms=100.0), Rec("s2v.adaln", None, 10, 20, device_ms=2.0),
            Rec("s2v.gate", None, 20, 30, device_ms=7.0), Rec("s2v.adaln", None, 30, 40, device_ms=3.0),
            Rec("s2v.adaln", None, 500, 600, device_ms=100.0)]
    run = run_of([("k", 0, 400)], (0, 400), recs, units=5)
    assert read("adaln_ms.generate", run) == pytest.approx(1.0)
    assert read("gate_ms.generate", run) == pytest.approx(7.0 / 5)
    assert read("qk_rope_ms.generate", run) is None  # no such span in the window


def test_a_spans_device_ms_leave_out_the_idle_inside_it():
    # the backward's events span 10 ms; the device idles 2 ms of it (a guard's gap
    # 30..32 under a child sync span) and 1 ms (50..51, the host in the backward itself)
    ms = 1_000_000
    recs = [Rec("s2v.train.backward", None, 20 * ms, 60 * ms, 10.0),
            Rec("s2v.sync.b1_guard", 0, 29 * ms, 32 * ms, 2.5),
            Rec("s2v.train.optimizer", None, 60 * ms, 70 * ms, 4.0)]
    ops = [("k", 0, 30 * ms), ("k", 32 * ms, 50 * ms), ("k", 51 * ms, 80 * ms)]
    run = run_of(ops, (0, 80 * ms), recs)
    assert read("backward_ms.train", run) == pytest.approx(10.0 - 3.0)
    assert read("optimizer_ms.train", run) == pytest.approx(4.0)  # no idle inside it


def test_train_spans_read_their_device_ms_children_included():
    recs = [Rec("s2v.train.step", None, 0, 100, 90.0), Rec("s2v.train.forward", 0, 0, 30, 30.0),
            Rec("s2v.train.backward", 0, 30, 80, 55.0), Rec("s2v.adaln", 2, 40, 50, 4.0),
            Rec("s2v.train.optimizer", 0, 80, 100, 5.0)]
    run = run_of([("k", 0, 100)], (0, 100), recs)
    assert read("backward_ms.train", run) == 55.0 and read("optimizer_ms.train", run) == 5.0


@pytest.mark.parametrize("metric", NEW_METRICS)
def test_no_records_or_no_device_operation_reads_none(metric):
    assert read(metric, run_of([("k", 0, 10)], (0, 100), [])) is None
    recs = [Rec("s2v.adaln", None, 10, 20), Rec("s2v.sync.b1_guard", 0, 12, 18)]
    assert read(metric, run_of([], (0, 100), recs)) is None  # the CPU: no device time, no gap to read


def test_the_new_metrics_are_declared_for_their_cells():
    per_layer = {m["name"]: m for m in json.loads((ROOT / "BENCHMARK.json").read_text())["per_layer"]}
    for name in NEW_METRICS:
        m = per_layer[name]
        assert m["unit"] == "ms" and m["better"] == "lower" and m["source"] == "device_trace"
        want = {"generate": ["5b-generate", "2b-generate"], "train": ["5b-lora-train"], "decode": ["5b-decode"]}
        assert m["workloads"] == want[name.split(".")[1]]


def test_the_timeline_takes_the_innermost_span():
    recs = [Rec("a", None, 0, 100), Rec("b", 0, 10, 40), Rec("c", 1, 20, 30), Rec("d", 0, 60, 70)]
    assert spans.timeline(recs) == [(0, 10, 0), (10, 20, 1), (20, 30, 2), (30, 40, 1), (40, 60, 0), (60, 70, 3),
                                    (70, 100, 0)]
