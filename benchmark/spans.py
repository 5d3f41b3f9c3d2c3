"""The program's own spans in a traced run, for the per-layer readers of
``metrics/``: the records ``s2v_torch.utils.logging`` keeps while a
profiler runs (``span_records``: name, parent, host interval in Unix ns
on the trace's clock, device ms between two CUDA events, attributes),
clipped to the traced window, and the window's idle gaps put down to them.

Gaps are the stretches of the window with no device operation, found as
``trace.Trace.idle_gaps`` finds them.  A gap that opens while the host is
inside an ``s2v.sync.*`` span (or a span under one) is the program's sync:
all of it is sync idle.  Every other gap is shared among the innermost
program spans open on the host while it lasts, by overlap: host idle.
Idle in ``s2v.callback`` (the caller's code inside the program's loop) or
under no program span is the benchmark's own host time and no metric takes
it.  Idle under ``s2v.prologue`` is a clip's start: counted once a clip
and weighed 1 in its steps (the span's ``steps``), as ``denoise_step_s``
weighs a clip's first step.  A span's device ms are its events' time
less the window's idle inside it, which is the idle while the host is
inside the span (the device idles inside a span's events only while the
host has entered the span and not yet left it): busy time.  A run whose
program keeps no records (one that predates them) reads None.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Tuple

SYNC_PREFIX = "s2v.sync."
CALLER_SPAN = "s2v.callback"
PROLOGUE_SPAN = "s2v.prologue"


def records(run) -> Optional[list]:
    """The program's span records of the traced run (``run.span_records``
    where the caller hands them in), or None where there are none."""
    recs = getattr(run, "span_records", None)
    if recs is None:
        try:
            from s2v_torch.utils.logging import span_records
        except ImportError:
            return None
        recs = span_records()
    return list(recs) or None


def in_window(run, recs: list) -> list:
    """The closed records that started inside the traced window."""
    lo, hi = run.trace.window
    return [r for r in recs if r.end_ns is not None and lo <= r.start_ns < hi]


def device_ms_per_unit(run, name: str) -> Optional[float]:
    """Device busy ms per unit of work in the spans named ``name`` that
    started in the window (a span's children included); None without such
    spans or without device times."""
    recs = records(run)
    if recs is None or run.units == 0:
        return None
    chosen = [r for r in in_window(run, recs) if r.name == name]
    if not chosen or any(r.device_ms is None for r in chosen):
        return None
    gs = gaps(run.trace)
    starts = [g[0] for g in gs]
    return sum(r.device_ms - idle_ns(gs, starts, r.start_ns, r.end_ns) / 1e6 for r in chosen) / run.units


def gaps(trace) -> List[Tuple[int, int]]:
    """Every idle stretch of the window, in time order, as ``Trace.idle_gaps`` finds them."""
    lo, hi = trace.window
    out, end = [], lo
    for s, e in sorted((s, e) for _, s, e in trace.in_window()):
        if s > end:
            out.append((end, s))
        end = max(end, e)
    if hi > end:
        out.append((end, hi))
    return out


def idle_ns(gs: List[Tuple[int, int]], starts: List[int], t0: int, t1: int) -> int:
    """The ns of the gaps ``gs`` (``starts`` their starts) inside ``[t0, t1)``."""
    k = max(bisect.bisect_right(starts, t0) - 1, 0)
    out = 0
    while k < len(gs) and gs[k][0] < t1:
        out += max(0, min(gs[k][1], t1) - max(gs[k][0], t0))
        k += 1
    return out


def timeline(recs: list) -> List[Tuple[int, int, int]]:
    """The host's time as ``(t0, t1, i)`` pieces in time order, ``i`` the
    index in ``recs`` of the innermost closed span open over the piece
    (spans nest: a span that starts inside another ends inside it); time
    under no span is left out."""
    out: List[Tuple[int, int, int]] = []
    stack: List[Tuple[int, int]] = []  # (end, index), innermost last
    t = None

    def close_until(s):
        nonlocal t
        while stack and stack[-1][0] <= s:
            end, i = stack.pop()
            if end > t:
                out.append((t, end, i))
                t = end

    closed = [j for j, r in enumerate(recs) if r.end_ns is not None]
    for i in sorted(closed, key=lambda j: (recs[j].start_ns, -recs[j].end_ns)):
        s = recs[i].start_ns
        if t is not None:
            close_until(s)
            if stack and s > t:
                out.append((t, s, stack[-1][1]))
        t = s if t is None else max(t, s)
        stack.append((recs[i].end_ns, i))
    if t is not None:
        close_until(float("inf"))
    return out


def attribute(recs: list, trace) -> List[Tuple[int, int, Optional[int], List[Tuple[int, int]]]]:
    """Each gap of the window as ``(g0, g1, opener, cover)``: ``opener`` the
    index of the innermost span open on the host when it opened (None:
    none), ``cover`` the ``(index, ns)`` of the innermost spans open over
    it, in time order."""
    pieces = timeline(recs)
    starts = [p[0] for p in pieces]
    out = []
    for g0, g1 in gaps(trace):
        k = bisect.bisect_right(starts, g0) - 1
        opener = pieces[k][2] if k >= 0 and pieces[k][0] <= g0 < pieces[k][1] else None
        cover, k = [], max(k, 0)
        while k < len(pieces) and pieces[k][0] < g1:
            t0, t1, i = pieces[k]
            overlap = min(t1, g1) - max(t0, g0)
            if overlap > 0:
                cover.append((i, overlap))
            k += 1
        out.append((g0, g1, opener, cover))
    return out


def idle(run) -> Optional[Dict[str, float]]:
    """The window's device idle in ns put down to the program: ``sync``
    (gaps opened inside a sync span), ``host`` (the rest, by overlap with
    the innermost program span, outside clip prologues), ``prologue`` (the
    same inside them) and ``prologue_per_step`` (each prologue's idle over
    its clip's steps, the mean over the window's prologues); None without
    records or without device operations."""
    recs = records(run)
    if recs is None or not run.trace.ops:  # no device operation traced: no gap to read
        return None
    kind = kinds(recs)
    out = {"sync": 0.0, "host": 0.0, "prologue": 0.0}
    per_prologue: Dict[int, float] = {}
    for g0, g1, opener, cover in attribute(recs, run.trace):
        if opener is not None and kind[opener][0] == "sync":
            out["sync"] += g1 - g0
            continue
        for i, overlap in cover:
            what, prologue = kind[i]
            if what == "caller":
                continue
            if prologue is None:
                out["host"] += overlap
            else:
                out["prologue"] += overlap
                per_prologue[prologue] = per_prologue.get(prologue, 0.0) + overlap
    lo, hi = run.trace.window
    clips = [j for j, r in enumerate(recs)
             if r.name == PROLOGUE_SPAN and r.end_ns is not None and r.start_ns < hi and r.end_ns > lo]
    out["prologue_per_step"] = (sum(per_prologue.get(j, 0.0) / max(int(recs[j].attrs.get("steps", 1)), 1)
                                    for j in clips) / len(clips)) if clips else 0.0
    return out


def kinds(recs: list) -> List[Tuple[str, Optional[int]]]:
    """Per record: ``sync`` (a sync span or one under it), ``caller`` (under
    ``s2v.callback``) or ``host``, and the index of the clip prologue it
    lies under, if any."""
    out: List[Tuple[str, Optional[int]]] = []
    for i, r in enumerate(recs):  # a parent opens before its children, so it is classed first
        what, prologue = out[r.parent] if r.parent is not None and 0 <= r.parent < i else ("host", None)
        if r.name.startswith(SYNC_PREFIX):
            what = "sync"
        elif r.name == CALLER_SPAN:
            what = "caller"
        elif r.name == PROLOGUE_SPAN:
            prologue = i
        out.append((what, prologue))
    return out


def idle_ms_per_unit(run, part: str) -> Optional[float]:
    """Device-idle ms per unit of work: ``sync``, or ``host`` (with each
    clip prologue's idle weighed 1 in its steps)."""
    split = idle(run)
    if split is None or run.units == 0:
        return None
    if part == "sync":
        return split["sync"] / run.units / 1e6
    return (split["host"] / run.units + split["prologue_per_step"]) / 1e6
