"""Runs one cell of ``BENCHMARK.json`` once: set-up, the measured window,
the traced window with ``--trace 1``, the check against the plain
reference, and the result line.

Everything particular to a cell is found by name: the configuration's file
(``BENCHMARK.json``'s ``configs[].file``), the traffic mix
(``traffic/<traffic>.json``, whose ``entry`` names the driver
``entries/<entry>.py``), the limits of the check (``limits/<cell>.json``)
and one reader per per-layer metric (``metrics/<metric>.py``, or
``metrics/<family>.py`` for a metric ``<family>.<suffix>`` with no file of
its own).  A new cell, configuration or metric is new files and new
entries there.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path
from typing import Callable, Dict, Optional

HERE = Path(__file__).resolve().parent
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "s2v_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """A cell's definition, read from the benchmark's files."""

    def __init__(self, root: Path, name: str, bench_dir: Path = HERE):
        self.root, self.dir = root, bench_dir
        self.spec = load_json(root / "BENCHMARK.json")
        by_name = {w["name"]: w for w in self.spec["workloads"]}
        if name not in by_name:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(by_name)})")
        self.name, self.workload = name, by_name[name]
        config = {c["name"]: c for c in self.spec["configs"]}[self.workload["config"]]
        self.config = load_json(root / config["file"])
        self.traffic = load_json(bench_dir / "traffic" / f"{self.workload['traffic']}.json")
        self.limits = load_json(bench_dir / "limits" / f"{name}.json")

    def applies(self, metric: dict) -> bool:
        return "workloads" not in metric or self.name in metric["workloads"]

    def end_to_end(self):
        return [m for m in self.spec["end_to_end"] if self.applies(m)]

    def per_layer(self):
        return [m for m in self.spec["per_layer"] if self.applies(m)]

    def entry(self, seed: int, device):
        mod = load_module(self.dir / "entries" / f"{self.traffic['entry']}.py", f"bench_entry_{self.traffic['entry']}")
        return mod.Entry(self.config, self.traffic, seed, device)

    def reader(self, metric: str) -> Callable:
        """``metrics/<metric>.py``, else the family's ``metrics/<name before the first dot>.py``."""
        path = self.dir / "metrics" / f"{metric}.py"
        if not path.is_file():
            path = self.dir / "metrics" / f"{metric.split('.')[0]}.py"
        return load_module(path, f"bench_metric_{path.stem}").read


def process_age_s() -> Optional[float]:
    """Seconds since this process started, from the kernel's record of it."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return None
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def forbidden_modules() -> list:
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN_MODULES})


def refuse_forbidden_modules() -> None:
    """Exit non-zero, naming them on standard error, if JAX or the JAX package was loaded."""
    found = forbidden_modules()
    if found:
        raise SystemExit(f"the run loaded {', '.join(found)}: the benchmark runs the port alone")


class Window:
    """The measured window: ``stop()`` is called by the entry after each
    unit of work (the device synced), marks the unit's end and says whether
    time is up."""

    def __init__(self, seconds: float, sync: Callable[[], None]):
        self.seconds, self.sync = seconds, sync
        self.t0 = self.t1 = 0.0
        self.marks = []

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def stop(self) -> bool:
        self.sync()
        self.marks.append(time.perf_counter())
        return self.marks[-1] - self.t0 >= self.seconds

    def durations(self) -> list:
        """Each unit's seconds, the last one's to the window's close."""
        ends = self.marks[:-1] + [self.t1]
        return [b - a for a, b in zip([self.t0] + ends[:-1], ends)]

    def __exit__(self, *exc):
        self.sync()
        self.t1 = time.perf_counter()

    @property
    def elapsed(self) -> float:
        return self.t1 - self.t0


def run_cell(cell: Cell, seed: int, seconds: float, trace_on: bool, device, control: bool = False,
             log=print) -> dict:
    """One run of ``cell``; returns the result object (the last line)."""
    import torch

    from benchmark import trace

    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    entry = cell.entry(seed, device)
    entry.setup()
    sync()
    age = process_age_s()
    setup_s = age if age is not None else time.perf_counter() - entry.t_created
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)  # the peak of the window, with everything resident
    prof = trace.start(device) if trace_on else None
    with torch.profiler.record_function(trace.WINDOW_SPAN), Window(seconds, sync) as window:
        units = entry.run(window.stop)
    traced = trace.stop(prof) if prof is not None else None
    refuse_forbidden_modules()
    peak = int(torch.cuda.max_memory_allocated(device)) if cuda else 0
    durations = window.durations()
    unit_s = entry.unit_seconds(durations) if hasattr(entry, "unit_seconds") else window.elapsed / max(units, 1)

    program_checks, control_checks, failed = entry.check(control=control)
    # with --control 1 the control stands in the program's place: its readings decide `correct`
    checks = control_checks if control else program_checks
    limits = cell.limits
    missing = sorted(set(checks) - set(limits))
    if missing:
        raise KeyError(f"limits/{cell.name}.json has no limit for {missing}")
    correct = all(math.isfinite(v) and v <= limits[k] for k, v in checks.items()) and failed == 0

    device_info = {"platform": "gpu" if cuda else device.type,
                   "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                   "count": 1, "memory_peak_bytes": peak}
    result = {"correct": bool(correct), "attempted": int(units), "failed": int(failed)}
    metrics: Dict[str, dict] = {}
    if not trace_on:
        values = {"setup_s": setup_s, entry.unit_metric: unit_s}
        for m in cell.end_to_end():
            if m["name"] not in values:
                raise KeyError(f"the {cell.traffic['entry']} entry gives no {m['name']}")
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        ctx = TracedRun(cell, entry, traced, units, unit_s)
        for m in cell.per_layer():
            value = cell.reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device_info.update(busy_s=traced.busy_s(), window_s=traced.window_s)
        result["breakdown"] = {"device_ops": traced.top_ops(10), "idle_gaps": traced.idle_gaps(10)}
    result["metrics"] = metrics
    result["device"] = device_info
    result["checks"] = {k: {"value": v, "limit": limits[k]} for k, v in checks.items()}
    for line in getattr(entry, "notes", list)():
        log(line)
    if control:
        for k, v in program_checks.items():
            log(f"program {k} {v!r} (the control is compared)")
    for k, v in checks.items():
        log(f"check {'control ' if control else ''}{k} {v!r} limit {limits[k]!r}")
    refuse_forbidden_modules()
    return result


class TracedRun:
    """What a per-layer reader reads: the trace of the window, the units
    of work done in it, the seconds of a unit as the end-to-end metric
    gives them, and the entry's work counts."""

    def __init__(self, cell: Cell, entry, trace, units: int, unit_s: float):
        self.cell, self.entry, self.trace, self.units, self.unit_s = cell, entry, trace, units, unit_s
