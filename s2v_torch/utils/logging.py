"""Logging and phase annotation (counterpart of ``s2v_tpu/utils/logging.py``).

``get_logger`` configures the port's root logger ``s2v_torch`` once: one
handler on standard error, the level from ``S2V_TORCH_LOG_LEVEL`` (default
``INFO``).  ``phase("s2v.denoise")`` is the port's one span API, and
``progress`` is a tqdm-free progress line for host loops.

Spans.  With no ``torch.profiler`` session running, ``phase`` is one check
of the profiler's flag and a shared no-op context: no ``record_function``,
no clock read, no CUDA event.  While a session runs (the CLI's
``--profile_dir``, a benchmark's traced window), each span enters the
profiler's record function (its C++ form, ``_RecordFunctionFast``, where
the build has it), so it shows in an exported Chrome trace, and
records its name, its parent (the span open when it began, on any thread:
the backward that autograd runs on its own device thread nests under the
span that called it), its host interval in Unix nanoseconds
(``time.time_ns``, the clock Kineto stamps its CPU events on), keyword
attributes such as a step's index, and on CUDA two timing events recorded
on the current device's current stream around it (:func:`span_device`),
resolved only when read: no span syncs.  The records are flat lists, so a
span leaves no object for Python's collector to track.  ``span_records()``
returns them as :class:`SpanRecord` s of the current (or the last) session;
they are dropped when a span opens in a new session, one that starts after
a span ran with no session, or by ``clear_spans()``.  ``span_summary``
folds them by name.
"""

from __future__ import annotations

import contextlib
import logging
import os
import sys
import time
from typing import Dict, List, Optional

import torch

LEVEL_VARIABLE = "S2V_TORCH_LOG_LEVEL"
_FORMAT = "%(asctime)s [%(levelname)s] %(name)s: %(message)s"
_configured = False


class _StderrHandler(logging.StreamHandler):
    """Writes to ``sys.stderr`` as it is when the record is emitted, so a
    stream swapped after the handler was made (a test's capture) gets it."""

    @property
    def stream(self):
        return sys.stderr

    @stream.setter
    def stream(self, _value):
        pass


def get_logger(name: str = "s2v_torch") -> logging.Logger:
    global _configured
    if not _configured:
        handler = _StderrHandler()
        handler.setFormatter(logging.Formatter(_FORMAT))
        root = logging.getLogger("s2v_torch")
        root.addHandler(handler)
        root.setLevel(os.environ.get(LEVEL_VARIABLE, "INFO").upper())
        root.propagate = False
        _configured = True
    return logging.getLogger(name)


class SpanRecord:
    """One span of a profiling session, as :func:`span_records` reads it:
    ``name``, ``parent`` (the index of the span open when it began, or
    None), ``start_ns``/``end_ns`` (host, Unix ns; ``end_ns`` is None while
    it is open), ``attrs`` and ``device_ms`` (device ms between the span's
    two timing events on its stream, idle stretches inside it included;
    None on the CPU or while it is open)."""

    __slots__ = ("name", "parent", "start_ns", "end_ns", "attrs", "device_ms")

    def __init__(self, name: str, parent: Optional[int], start_ns: int, end_ns: Optional[int],
                 attrs: Optional[dict] = None, device_ms: Optional[float] = None):
        self.name, self.parent, self.start_ns, self.end_ns = name, parent, start_ns, end_ns
        self.attrs, self.device_ms = attrs or {}, device_ms


# The current profiling session's spans, one entry of each list a span: flat
# lists of strings, ints and CUDA events (a C type the collector does not
# track), so that a span leaves no object behind for Python's collector and a
# traced window collects garbage as an untraced one does.
_names: List[str] = []
_parents: List[int] = []  # -1: none
_starts: List[int] = []
_ends: List[int] = []  # 0 while open
_events: list = []  # the start and end timing events, two a span (None on the CPU)
_attrs: Dict[int, dict] = {}  # only of the spans given attributes
_open: List[int] = []  # indices of the spans open now, innermost last
_session = 0  # counts the clears, so that a span open across one does not write into the next session
_stale = True  # a span ran with no session since the last record: the next record starts a new session


# the profiler's annotation made in C++, a tenth of ``torch.profiler.record_function``'s
# host cost and no object for the collector (where this build has it)
_record_function = getattr(torch._C._profiler, "_RecordFunctionFast", None) or torch.profiler.record_function


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Logged:
    """A span with no profiler running that logs its host seconds."""

    __slots__ = ("name", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        get_logger().info("%s: %.2fs", self.name.removeprefix("s2v."), time.perf_counter() - self.t0)
        return False


class _Span(_Logged):
    __slots__ = ("log", "attrs", "index", "session", "stream", "_rf")

    def __init__(self, name: str, log: bool, attrs: dict):
        super().__init__(name)
        self.log, self.attrs = log, attrs

    def __enter__(self):
        global _stale
        if _stale:
            clear_spans()
            _stale = False
        if self.log:
            self.t0 = time.perf_counter()
        self._rf = _record_function(self.name)
        self._rf.__enter__()
        i = self.index = len(_names)
        self.session = _session
        _names.append(self.name)
        _parents.append(_open[-1] if _open else -1)
        if self.attrs:
            _attrs[i] = self.attrs
        if torch.cuda.is_initialized():  # both events on the stream current when the span opens
            self.stream = torch.cuda.current_stream()
            start = torch._C._CudaEventBase(enable_timing=True)
            start.record(self.stream)
            _events.append(start)
            _events.append(torch._C._CudaEventBase(enable_timing=True))
        else:
            _events.append(None)
            _events.append(None)
        _ends.append(0)
        _starts.append(time.time_ns())
        _open.append(i)

    def __exit__(self, *exc):
        i = self.index
        if self.session == _session:
            _ends[i] = time.time_ns()
            end = _events[2 * i + 1]
            if end is not None:
                end.record(self.stream)
            if i in _open:  # spans close innermost first, also when an exception unwinds them
                del _open[_open.index(i):]
        self._rf.__exit__(*exc)
        if self.log:
            super().__exit__(*exc)
        return False


def phase(name: str, log: bool = False, **attrs):
    """A span named ``name`` (the ``s2v.*`` names, see the module doc):
    ``with phase("s2v.step", step=i): ...``.  ``log=True`` also logs its
    host seconds.  With no profiler running it records nothing."""
    # the profiler's process-wide flag, set while a session runs on any thread
    # (autograd's device threads see it too)
    if torch.autograd.profiler._is_profiler_enabled:
        return _Span(name, log, attrs)
    global _stale
    _stale = True
    return _Logged(name) if log else _OFF


def span_device(device: torch.device):
    """Makes ``device`` the current CUDA device while it is open (nothing
    for another device): spans time the current device's current stream,
    so the pipeline and the trainers open it around their work."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def clear_spans() -> None:
    """Drop the records now."""
    global _session
    _session += 1
    for store in (_names, _parents, _starts, _ends, _events, _open):
        store.clear()
    _attrs.clear()


def open_span_names() -> List[str]:
    """The names of the spans open now, outermost first."""
    return [_names[i] for i in _open]


def span_records() -> List[SpanRecord]:
    """The spans of the current (or the last) profiling session, in the
    order they opened; the device times are resolved here (the first read
    waits for the last span's end event)."""
    out = []
    for i, name in enumerate(_names):
        end, start_ev, end_ev = _ends[i] or None, _events[2 * i], _events[2 * i + 1]
        ms = None
        if end is not None and start_ev is not None:
            end_ev.synchronize()
            ms = start_ev.elapsed_time(end_ev)
        parent = _parents[i]
        out.append(SpanRecord(name, None if parent < 0 else parent, _starts[i], end, _attrs.get(i), ms))
    return out


def span_summary(records: Optional[List[SpanRecord]] = None, window: Optional[tuple] = None) -> Dict[str, list]:
    """``{name: [calls, host_ms, device_ms, self_device_ms]}`` over the
    closed spans of ``records`` (default: the session's) that started in
    ``window`` (``(lo_ns, hi_ns)``, default: all); self time is a span's
    device time less what its children cover.  Device values are None
    without timing events (the CPU)."""
    records = span_records() if records is None else records
    lo, hi = window if window is not None else (float("-inf"), float("inf"))
    child_ms: Dict[int, float] = {}
    for rec in records:
        if rec.parent is not None and rec.end_ns is not None and rec.device_ms is not None:
            child_ms[rec.parent] = child_ms.get(rec.parent, 0.0) + rec.device_ms
    out: Dict[str, list] = {}
    for i, rec in enumerate(records):
        if rec.end_ns is None or not lo <= rec.start_ns < hi:
            continue
        row = out.setdefault(rec.name, [0, 0.0, None, None])
        row[0] += 1
        row[1] += (rec.end_ns - rec.start_ns) / 1e6
        if rec.device_ms is not None:
            row[2] = (row[2] or 0.0) + rec.device_ms
            row[3] = (row[3] or 0.0) + rec.device_ms - child_ms.get(i, 0.0)
    return out


class progress:
    """Minimal tqdm-free progress reporter for host-side loops."""

    def __init__(self, total: int, desc: str = ""):
        self.total = total
        self.desc = desc
        self.n = 0
        self._t0 = time.perf_counter()

    def update(self, k: int = 1):
        self.n += k
        dt = time.perf_counter() - self._t0
        sys.stderr.write(f"\r{self.desc} {self.n}/{self.total} [{dt:.0f}s]")
        if self.n >= self.total:
            sys.stderr.write("\n")
        sys.stderr.flush()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False
