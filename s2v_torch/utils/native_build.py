"""Build the port's native sources into ``<repo>/build`` at first use.

Each source is compiled into a shared library with a plain C interface,
loaded with ``ctypes`` by a :class:`Library` that declares its entries.
The library name carries a hash of the source, of the local headers it
includes (``csrc/hopper.cuh``) and of the command, so an edited source or
header is rebuilt and a stale build never loads.
Compilers run only when a kernel is first needed on a machine that has them;
importing this module starts nothing.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Mapping, Optional, Sequence

REPO_ROOT = Path(__file__).resolve().parents[2]
BUILD_DIR = REPO_ROOT / "build"
CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
GXX_FLAGS = ["-std=c++17", "-O2", "-shared", "-fPIC"]
# libraries a source links, by its stem (after the source on the command line)
LINK_LIBS = {"mp4_muxer": ["-lavformat", "-lavcodec", "-lavutil", "-lswscale"]}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")


def _command(src: Path, out: Path) -> List[str]:
    if src.suffix == ".cu":
        return [nvcc_path(), *NVCC_FLAGS, "-o", str(out), str(src)]
    return ["g++", *GXX_FLAGS, "-o", str(out), str(src), *LINK_LIBS.get(src.stem, [])]


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def local_includes(src: Path) -> List[Path]:
    """The files ``src`` names in ``#include "..."`` lines, found beside the
    file that names them, and theirs in turn (each once, in first-seen
    order); system headers (``<...>``) are not followed."""
    seen: List[Path] = []
    todo = [Path(src)]
    while todo:
        current = todo.pop(0)
        for name in _INCLUDE.findall(current.read_bytes()):
            header = current.parent / name.decode()
            if header.is_file() and header not in seen:
                seen.append(header)
                todo.append(header)
    return seen


def library_path(src: Path) -> Path:
    """Where the build of ``src`` lives; the name changes with its content
    and with the content of every local header it includes."""
    digest = hashlib.sha256(src.read_bytes())
    for header in local_includes(src):
        digest.update(header.name.encode())
        digest.update(header.read_bytes())
    flags = NVCC_FLAGS if src.suffix == ".cu" else GXX_FLAGS + LINK_LIBS.get(src.stem, [])
    digest.update(" ".join(flags).encode())
    return BUILD_DIR / f"lib{src.stem}-{digest.hexdigest()[:12]}.so"


def build(sources: Sequence[Path]) -> Dict[str, dict]:
    """Compile every source not yet built, one compiler process each, all
    started together.  Returns ``{stem: {"path", "seconds", "log"}}``;
    raises with the compiler's output when a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    results: Dict[str, dict] = {}
    running = []
    for src in sources:
        src = Path(src)
        out = library_path(src)
        if out.exists():
            results[src.stem] = {"path": out, "seconds": 0.0, "log": "cached"}
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen(
            _command(src, tmp), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        running.append((src, out, tmp, proc, time.perf_counter()))
    for src, out, tmp, proc, t0 in running:
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"building {src.name} failed ({proc.returncode}):\n{log}")
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
        results[src.stem] = {"path": out, "seconds": seconds, "log": log}
    return results


def launch_error(code: int) -> str:
    """Names an error code of a C entry point: a cudaError_t, or one of the
    TMA codes of ``csrc/hopper.cuh`` (10000: no tensor-map encoder in
    libcuda; 20000 + CUresult: a tensor map cuTensorMapEncodeTiled refused)."""
    if code == 10000:
        return "cuTensorMapEncodeTiled not found in libcuda"
    if code >= 20000:
        return f"TMA tensor map refused (CUresult {code - 20000})"
    return f"cudaError {code}"


def build_one(src: Path) -> Path:
    return build([src])[Path(src).stem]["path"]


class Library:
    """One native source and its C entries, ``{name: argument types}``.
    Nothing is built at construction: the first :meth:`load` builds the
    source (or finds its build), loads it once per process and declares
    every entry's ``argtypes`` and ``restype``: ``restype[name]`` where
    given, else ``c_int`` (a kernel's launch entry returns an error code
    that :func:`launch_error` names)."""

    def __init__(self, source: Path, entries: Mapping[str, Sequence[type]],
                 restype: Optional[Mapping[str, Optional[type]]] = None):
        self.source, self.entries, self.restype = Path(source), dict(entries), dict(restype or {})
        self._cdll: Optional[ctypes.CDLL] = None

    def load(self) -> ctypes.CDLL:
        if self._cdll is None:
            cdll = ctypes.CDLL(str(build_one(self.source)))
            for name, argtypes in self.entries.items():
                fn = getattr(cdll, name)
                fn.argtypes = list(argtypes)
                fn.restype = self.restype.get(name, ctypes.c_int)
            self._cdll = cdll
        return self._cdll

    def entry(self, name: str):
        """The declared C function ``name`` (loading the library first)."""
        if name not in self.entries:
            raise KeyError(f"{name} is not an entry declared for {self.source.name}")
        return getattr(self.load(), name)
