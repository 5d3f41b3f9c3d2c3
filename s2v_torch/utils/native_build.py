"""Build the port's native sources into ``<repo>/build`` at first use.

Each source is compiled into a shared library with a plain C interface,
loaded with ``ctypes``.  The library name carries a hash of the source and
the command, so an edited source is rebuilt and a stale one never loads.
Compilers run only when a kernel is first needed on a machine that has them;
importing this module starts nothing.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Sequence

REPO_ROOT = Path(__file__).resolve().parents[2]
BUILD_DIR = REPO_ROOT / "build"
CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
GXX_FLAGS = ["-std=c++17", "-O2", "-shared", "-fPIC"]


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
    return ["g++", *GXX_FLAGS, "-o", str(out), str(src)]


def library_path(src: Path) -> Path:
    """Where the build of ``src`` lives; the name changes with its content."""
    digest = hashlib.sha256(src.read_bytes())
    flags = NVCC_FLAGS if src.suffix == ".cu" else GXX_FLAGS
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


def build_one(src: Path) -> Path:
    return build([src])[Path(src).stem]["path"]
