"""The launch layer of the port's hand-written kernels, on the CPU: the
launch-count registry, the launch call's stream and error code, the
declared C entries against the ``extern "C"`` functions of their CUDA
sources, the needs-grad rule, and an import that builds and loads
nothing.  A misdeclared entry would otherwise show only on the card."""

import ctypes
import importlib
import importlib.util
import pkgutil
import re
import subprocess
import sys
import types
from pathlib import Path

import pytest
import torch

import s2v_torch.kernels
from s2v_torch.kernels import native
from s2v_torch.utils import native_build
from s2v_torch.utils.device import needs_grad

KERNEL_MODULES = [importlib.import_module(f"s2v_torch.kernels.{m.name}")
                  for m in pkgutil.iter_modules(s2v_torch.kernels.__path__)]


def _libraries():
    seen = {}
    for module in KERNEL_MODULES:
        for value in vars(module).values():
            if isinstance(value, native_build.Library):
                seen[id(value)] = value
    return sorted(seen.values(), key=lambda lib: lib.source.name)


LIBRARIES = _libraries()
DECLARED = [(lib, name) for lib in LIBRARIES for name in lib.entries]


def _kind(decl: str) -> str:
    """A C declaration's kind: a pointer, a 32- or 64-bit int, a float, void."""
    words = decl.replace("*", " * ").split()
    if "*" in words:
        return "ptr"
    if "long" in words:
        return "i64"
    if "float" in words:
        return "f32"
    if "int" in words:
        return "i32"
    if words == ["void"]:
        return "void"
    raise ValueError(f"no kind for the C declaration {decl!r}")


def _ctype_kind(t) -> str:
    if t is None:
        return "void"
    if t in (ctypes.c_void_p, ctypes.c_char_p) or issubclass(t, ctypes._Pointer):
        return "ptr"
    return {ctypes.c_int: "i32", ctypes.c_longlong: "i64", ctypes.c_float: "f32"}[t]


def _c_entries(source) -> dict:
    """``{name: (return kind, [parameter kinds])}`` of the ``extern "C"``
    functions of a source, its object-like macros expanded."""
    text = re.sub(r"/\*.*?\*/", " ", source.read_text(), flags=re.S)
    text = re.sub(r"//[^\n]*", " ", text).replace("\\\n", " ")
    macros = dict(re.findall(r"^[ \t]*#[ \t]*define[ \t]+(\w+)[ \t]+([^\n]*)$", text, flags=re.M))
    entries = {}
    for ret, name, params in re.findall(r'extern\s+"C"\s+([\w\s*]+?)\s*\b(\w+)\s*\(([^)]*)\)', text):
        for _ in range(4):  # macros that name macros
            params = re.sub(r"\w+", lambda m: macros.get(m.group(0), m.group(0)), params)
        decls = [p for p in (p.strip() for p in params.split(",")) if p and p != "void"]
        entries[name] = (_kind(ret), [_kind(p) for p in decls])
    return entries


def test_the_registry_counts_copies_and_resets():
    native.reset_counts()
    native.count("k", torch.bfloat16, batch=2)
    native.count("k", torch.float16, batch=1)
    native.count("k", torch.bfloat16, batch=2)
    native.count("k_plain")
    snapshot = native.counts()
    assert snapshot == {"k": {"launches": 3, "dtype": {"bfloat16": 2, "float16": 1}, "batch": {2: 2, 1: 1}},
                        "k_plain": {"launches": 1, "dtype": {}}}
    assert (native.launches("k"), native.launches("k", "bfloat16"), native.launches("k", torch.float16)) == (3, 2, 1)
    assert native.launches("never") == 0 and native.launches("k", "float32") == 0
    native.count("k", torch.float16, batch=1)
    assert snapshot["k"]["launches"] == 3 and snapshot["k"]["dtype"]["float16"] == 1  # a copy
    assert snapshot["k"]["batch"] == {2: 2, 1: 1}
    snapshot["k"]["dtype"]["float16"] = 99
    assert native.launches("k", "float16") == 2  # and the copy's edits do not reach the registry
    native.reset_counts()
    assert native.counts() == {} and native.launches("k") == 0


def test_the_smoke_reads_the_registry_by_name_and_every_new_kernel_with_it():
    spec = importlib.util.spec_from_file_location("chip_smoke", Path(__file__).parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    smoke.reset_counts()
    zeros = smoke.read_counts()
    assert all(zeros[k] == 0 and zeros[f"{k}_by_dtype"] == {} for k in smoke.ATTENTION_KERNELS)
    assert smoke.check_counts(zeros, "flash", 0, 0) and smoke._fp32_counts(zeros, "flash", 0, 0)
    native.count("flash_attention", torch.float32, batch=2)
    native.count("flash_attention_rerun")
    native.count("adaln_zero_join", torch.bfloat16)
    native.count("adaln_zero_join_plain")
    native.count("a_new_kernel", torch.float16)
    got = smoke.read_counts()
    assert (got["flash_attention"], got["reruns"], got["flash_attention_by_batch"]) == (1, 1, {"2": 1})
    assert (got["adaln"], got["adaln_plain"], got["adaln_by_dtype"]) == (1, 1, {"bfloat16": 1})
    assert (got["a_new_kernel"], got["a_new_kernel_by_dtype"]) == (1, {"float16": 1})
    assert smoke.check_counts(got, "flash", 0, 0)  # the re-run's launch is netted out
    assert smoke._fp32_counts(got, "flash", 0, 0)
    native.count("flash_attention", torch.bfloat16)
    assert smoke.check_counts(smoke.read_counts(), "flash", 1, 0)
    assert not smoke._fp32_counts(smoke.read_counts(), "flash", 1, 0)
    smoke.reset_counts()
    assert native.counts() == {}


def test_launch_passes_the_stream_last_and_raises_naming_the_entry(monkeypatch):
    calls = []

    class Lib:
        def entry(self, name):
            return lambda *args: calls.append((name, args)) or (20001 if name == "bad" else 0)

    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: types.SimpleNamespace(cuda_stream=77))
    native.launch(Lib(), "good", torch.device("cuda"), 1, 2.5)
    assert calls == [("good", (1, 2.5, 77))]
    with pytest.raises(RuntimeError, match=r"bad launch failed: TMA tensor map refused \(CUresult 1\)"):
        native.launch(Lib(), "bad", torch.device("cuda"))
    assert native.ptr(None) == 0 and native.ptr(torch.empty(3)) != 0


def test_every_kernel_module_declares_its_sources_and_entries():
    for module in KERNEL_MODULES:
        libs = [v for v in vars(module).values() if isinstance(v, native_build.Library)]
        sources = {v for k, v in vars(module).items() if k.endswith("SOURCE")}
        assert sources <= {lib.source for lib in libs}, module.__name__
        declared = {n for lib in libs for n in lib.entries}
        for table in (v for k, v in vars(module).items() if k.endswith("ENTRY") and isinstance(v, dict)):
            assert set(table.values()) <= declared, module.__name__
    assert len(LIBRARIES) >= 9 and len(DECLARED) >= 32
    with pytest.raises(KeyError, match="not an entry declared"):
        LIBRARIES[0].entry("s2v_no_such_entry")


@pytest.mark.parametrize("lib, name", DECLARED, ids=[f"{lib.source.stem}.{name}" for lib, name in DECLARED])
def test_a_declared_entry_matches_its_extern_c_function(lib, name):
    entries = _c_entries(lib.source)
    assert name in entries, f"{name} is no extern \"C\" function of {lib.source.name}"
    ret, params = entries[name]
    assert [_ctype_kind(t) for t in lib.entries[name]] == params
    assert _ctype_kind(lib.restype.get(name, ctypes.c_int)) == ret


def test_needs_grad_follows_grad_mode_and_the_inputs():
    x, w = torch.ones(2), torch.ones(2, requires_grad=True)
    assert needs_grad(x, w) and not needs_grad(x, x)
    with torch.no_grad():
        assert not needs_grad(x, w)
    with torch.inference_mode():
        assert not needs_grad(x, w)
    with torch.enable_grad():
        assert needs_grad(w)


def test_importing_the_port_builds_and_loads_nothing():
    code = """
import ctypes, subprocess, sys
import torch  # loads its own libraries first
def refuse(*a, **k):
    raise AssertionError(f"started at import: {a[:1]}")
subprocess.Popen = subprocess.run = ctypes.CDLL = refuse
import pkgutil, s2v_torch, s2v_torch.kernels
from s2v_torch.utils import mp4_native, native_build, sp_native
for m in pkgutil.iter_modules(s2v_torch.kernels.__path__):
    __import__(f"s2v_torch.kernels.{m.name}")
libs = [v for m in list(sys.modules.values()) if getattr(m, "__name__", "").startswith("s2v_torch")
        for v in vars(m).values() if isinstance(v, native_build.Library)]
assert len(libs) >= 11 and all(lib._cdll is None for lib in libs), libs
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), out.stderr[-2000:]
