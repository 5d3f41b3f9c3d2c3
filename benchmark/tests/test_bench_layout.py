"""What the benchmark may import, and that a new configuration, cell and
per-layer metric are picked up from new files and new BENCHMARK.json
entries alone, with no file that was there edited."""

from __future__ import annotations

import ast
import hashlib
import json

import pytest
import torch

from benchmark.harness import Cell, run_cell
from benchmark.tests.tiny import ROOT, make_checkout

BENCH = ROOT / "benchmark"
FORBIDDEN = {"jax", "jaxlib", "flax", "s2v_tpu", "bench", "bench_runs"}


def imported_top_names(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_module_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        assert not imported_top_names(path) & FORBIDDEN, path


def test_the_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").rglob("*.py"):
        assert "s2v_torch" not in imported_top_names(path), path


def test_whole_names_are_compared(monkeypatch):
    import sys

    from benchmark.harness import forbidden_modules

    import s2v_torch  # noqa: F401  the port's name begins with the JAX package's

    assert forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "s2v_tpu.models", sys.modules["s2v_torch"])
    assert forbidden_modules() == ["s2v_tpu.models"]


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in root.rglob("*") if p.is_file() and "__pycache__" not in p.parts}


@pytest.mark.parametrize("reader", ["units.tiny.py", "units.py"])
def test_new_files_and_entries_add_a_config_cell_and_metric(tmp_path, reader):
    """The metric's reader is its own file, or its family's (the name before the first dot)."""
    root = make_checkout(tmp_path)  # adds tiny configurations, traffic, limits and cells as new files
    before = _digests(BENCH)
    (root / "benchmark" / "metrics" / reader).write_text(
        '"""units.tiny: the units of work in the traced window."""\n\n\ndef read(run):\n    return float(run.units)\n')
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["per_layer"].append({"name": "units.tiny", "unit": "count", "better": "higher", "source": "program_counter",
                              "layer": "model step", "moves": "decode_s", "workloads": ["tiny-5b-decode"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    r = run_cell(Cell(root, "tiny-5b-decode", root / "benchmark"), 5, 0.05, True, torch.device("cpu"),
                 log=lambda line: None)
    assert r["correct"] and r["metrics"]["units.tiny"]["value"] == r["attempted"]
    copied = _digests(root / "benchmark")
    assert all(copied[p] == d for p, d in before.items())  # every file that was there is unchanged


def test_a_module_loaded_during_the_check_refuses_the_result(tmp_path, monkeypatch):
    """The look for JAX is the last step before the result, after the check against the reference."""
    import sys
    import types

    root = make_checkout(tmp_path)
    cell = Cell(root, "tiny-5b-decode", root / "benchmark")
    make_entry = cell.entry

    def entry_loading_jax(seed, device):
        entry = make_entry(seed, device)
        real = entry.check

        def check(control=False):
            monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
            return real(control=control)

        entry.check = check
        return entry

    monkeypatch.setattr(cell, "entry", entry_loading_jax)
    with pytest.raises(SystemExit, match="jax"):
        run_cell(cell, 5, 0.05, False, torch.device("cpu"), log=lambda line: None)
