"""The launch layer of the port's hand-written kernels: one launch call and
one launch-count registry, beside the loader
(``utils/native_build.py::Library``) that each wrapper declares its
source and C entries with.

:func:`launch` calls a launch entry with its arguments and the current
CUDA stream of a device, and raises on its error code.  :func:`count`
records each launch by kernel, in total, by element type and by any keyword
the wrapper gives (B1 its batch), and the events beside the launches under
names of their own: B1's online re-runs (``flash_attention_rerun``), B3's
pre-pass (``flash_attention_qk_int8_prepass``) and the calls that took a
plain chain (``adaln_zero_join_plain``, ``qk_norm_rope_plain``).
:func:`launches` reads one count, :func:`counts` copies them all and
:func:`reset_counts` clears them.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Union

import torch

from s2v_torch.utils import native_build

# the C argument types of the entries' tables
PTR, I32, I64, F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# the last argument of every launch entry, which launch() passes
STREAM = ctypes.c_void_p


def ptr(t: Optional[torch.Tensor]) -> int:
    """A tensor's address for a pointer argument; None passes NULL."""
    return 0 if t is None else t.data_ptr()


def launch(lib: native_build.Library, name: str, device: torch.device, *args) -> None:
    """Call ``lib``'s launch entry ``name`` with ``args`` and the current
    CUDA stream of ``device``; raise naming the entry on a non-zero code."""
    err = lib.entry(name)(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: {native_build.launch_error(err)}")


_counts: Dict[str, dict] = {}


def _dtype_name(dtype: Union[torch.dtype, str]) -> str:
    return str(dtype).replace("torch.", "")


def count(kernel: str, dtype: Optional[torch.dtype] = None, **by) -> None:
    """One launch of ``kernel`` (or one event of that name), counted in
    total, by element type when given, and by each keyword's value
    (``batch=2``)."""
    c = _counts.get(kernel)
    if c is None:
        c = _counts[kernel] = {"launches": 0, "dtype": {}}
    c["launches"] += 1
    if dtype is not None:
        name = _dtype_name(dtype)
        c["dtype"][name] = c["dtype"].get(name, 0) + 1
    for key, value in by.items():
        table = c.get(key)
        if table is None:
            table = c[key] = {}
        table[value] = table.get(value, 0) + 1


def launches(kernel: str, dtype: Union[torch.dtype, str, None] = None) -> int:
    """``kernel``'s count so far, or its count of one element type."""
    c = _counts.get(kernel)
    if c is None:
        return 0
    return c["launches"] if dtype is None else c["dtype"].get(_dtype_name(dtype), 0)


def counts() -> Dict[str, dict]:
    """A copy of every count, ``{kernel: {"launches": n, "dtype": {name: n},
    <keyword>: {value: n}}}``, that later counts leave as it is."""
    return {kernel: {key: dict(v) if isinstance(v, dict) else v for key, v in c.items()}
            for kernel, c in _counts.items()}


def reset_counts() -> None:
    """Every count back to 0."""
    _counts.clear()
