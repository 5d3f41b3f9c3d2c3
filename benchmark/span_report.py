"""The program's spans in one cell, for reading where its time and its idle
go (not part of a check):

    python3 benchmark/span_report.py --workload <name> --seed <n> --seconds <s> [--sync_check 1]

run from the root of a checkout with a CUDA device.  It sets the cell up as
``run.py`` does, traces the measured window, and prints one JSON line: the
window's idle share and unit seconds, the collector's pauses in it
(``gc.callbacks``), each span's calls and device busy ms per unit of work
(as the readers take them: less the idle inside it), the sums that
``other_ms`` and the device's busy time are held against, the per-layer
readers of ``spans.py``, and the window's longest idle gaps as
``spans.attribute`` puts them down, each with the host operations and
collector pauses over it.  A program without spans reads the trace's
numbers alone.  With ``--sync_check 1`` it first runs one unit of work
under ``torch.cuda.set_sync_debug_mode("warn")`` and lists every
synchronizing call with the spans open around it: those outside an
``s2v.sync.*`` span are ``unnamed``.  The check against the reference is
skipped.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
import traceback
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

OTHER_SPANS = ("s2v.adaln", "s2v.qk_rope", "s2v.gate", "s2v.gelu", "s2v.cfg_ddim")
STEP_SPANS = ("s2v.train.forward", "s2v.train.backward", "s2v.train.optimizer")


def sync_check(entry) -> dict:
    """One unit of work under the sync debug mode and a CPU profiler (so the
    spans record): every synchronizing call and the spans open at it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from s2v_torch.utils.logging import clear_spans, open_span_names

    seen = []

    def hook(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        names = open_span_names()
        frames = [f"{Path(f.filename).parent.name}/{Path(f.filename).name}:{f.lineno} {f.name}"
                  for f in traceback.extract_stack()[:-1] if "warnings" not in f.filename]
        seen.append({"spans": names, "named": any(n.startswith("s2v.sync.") for n in names),
                     "where": frames[-3:]})

    clear_spans()
    torch.cuda.set_sync_debug_mode("warn")  # before the hook: switching warns too
    try:
        with profile(activities=[ProfilerActivity.CPU]), warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = hook
            entry.run(lambda: True)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    sites = {}
    for s in seen:
        key = s["spans"][-1] if s["named"] else "unnamed: " + " | ".join(s["where"])
        sites[key] = sites.get(key, 0) + 1
    return {"syncs": len(seen), "unnamed": sum(1 for s in seen if not s["named"]), "sites": sites}


def host_events(prof) -> list:
    """The traced window's host operations (``aten::`` ops and the like) as
    (name, start_ns, end_ns), the program's and the benchmark's spans left out."""
    out = []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if str(e.device_type()).endswith("CPU") and not name.startswith(("s2v.", "bench.")):
            out.append((name, e.start_ns(), e.start_ns() + e.duration_ns()))
    return out


def overlaps(intervals, g0, g1, k=6) -> dict:
    """``{name: [ms, count]}`` of the intervals overlapping ``[g0, g1)``, the largest ``k``."""
    by = {}
    for name, s, e in intervals:
        o = min(e, g1) - max(s, g0)
        if o > 0:
            row = by.setdefault(name, [0.0, 0])
            row[0] += o / 1e6
            row[1] += 1
    return dict(sorted(by.items(), key=lambda kv: -kv[1][0])[:k])


def report(run, top: int = 12, host_ops=(), collections=()) -> dict:
    from benchmark import readers, spans, trace

    other = readers.per_unit_ms(run, lambda n: trace.attention_family(n) is None and not trace.is_matmul(n))
    units = max(run.units, 1)
    out = {"units": run.units, "other_ms": other, "busy_ms": 1e3 * run.trace.busy_s() / units}
    recs = spans.records(run)
    if recs is None:  # a program without spans
        return out
    gs = spans.gaps(run.trace)
    starts = [g[0] for g in gs]
    summary = {}
    for r in spans.in_window(run, recs):
        row = summary.setdefault(r.name, [0, 0.0])
        row[0] += 1
        if r.device_ms is not None:
            row[1] += (r.device_ms - spans.idle_ns(gs, starts, r.start_ns, r.end_ns) / 1e6) / units

    def ms(name):
        return (summary.get(name) or [0, 0.0])[1]

    kind = spans.kinds(recs)
    gap_rows = []
    for g0, g1, opener, cover in sorted(spans.attribute(recs, run.trace), key=lambda g: g[0] - g[1])[:top]:
        by = {}
        for i, ns in cover:
            chain, j = [], i
            while j is not None and len(chain) < 3:
                chain.append(recs[j].name)
                j = recs[j].parent
            key = " < ".join(chain)
            by[key] = by.get(key, 0) + ns / 1e6
        gap_rows.append({"ms": (g1 - g0) / 1e6, "opens_in": None if opener is None else recs[opener].name,
                         "sync": opener is not None and kind[opener][0] == "sync",
                         "covered_ms": dict(sorted(by.items(), key=lambda kv: -kv[1])[:3]),
                         "host_ops": overlaps(host_ops, g0, g1), "gc": overlaps(collections, g0, g1)})
    out.update(busy_ms_per_span=summary, five_spans_ms=sum(ms(n) for n in OTHER_SPANS),
               train_spans_ms=sum(ms(n) for n in STEP_SPANS),
               idle_split_ms={k: v / 1e6 for k, v in (spans.idle(run) or {}).items()},
               sync_idle_ms=spans.idle_ms_per_unit(run, "sync"), host_idle_ms=spans.idle_ms_per_unit(run, "host"),
               gaps=gap_rows)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--sync_check", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch
    from torch.profiler import record_function

    from benchmark import trace
    from benchmark.harness import Cell, TracedRun, Window

    device = torch.device("cuda", 0)

    def sync():
        torch.cuda.synchronize(device)

    cell = Cell(ROOT, args.workload)
    entry = cell.entry(args.seed, device)
    entry.setup()
    out = {"workload": args.workload, "seed": args.seed, "device": torch.cuda.get_device_name(device)}
    if args.sync_check:
        out["sync_check"] = sync_check(entry)
    sync()
    collections, started = [], {}

    def on_gc(phase, info):  # the collector's pauses, on the trace's clock
        if phase == "start":
            started["t"] = time.time_ns()
        elif "t" in started:
            collections.append((f"gen{info['generation']}", started.pop("t"), time.time_ns()))

    gc.callbacks.append(on_gc)
    prof = trace.start(device)
    try:
        with record_function(trace.WINDOW_SPAN), Window(args.seconds, sync) as window:
            units = entry.run(window.stop)
    finally:
        gc.callbacks.remove(on_gc)
    traced = trace.stop(prof)
    host_ops = host_events(prof)
    durations = window.durations()
    unit_s = entry.unit_seconds(durations) if hasattr(entry, "unit_seconds") else window.elapsed / max(units, 1)
    run = TracedRun(cell, entry, traced, units, unit_s)
    out.update(unit_s=unit_s, idle_share=traced.idle_share(),
               gc={g: [sum(1 for n, _, _ in collections if n == g),
                       sum((e - s) / 1e6 for n, s, e in collections if n == g)] for g in ("gen0", "gen1", "gen2")},
               report=report(run, host_ops=host_ops, collections=collections))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
