"""The arithmetic the per-layer readers in ``metrics/`` share.  Each reader
is one file, found by its metric's name (or its family's, the name before
the first dot), with a ``read(run)`` over the traced run; a reader that
finds nothing to read returns None and the metric is left out of the
line."""

from __future__ import annotations

from typing import Callable, Optional

from benchmark import flops, trace


def roofline(run, family: str, count_symbol: str, work: Callable) -> Optional[float]:
    """The least time of one call at the cell's shape over the mean device
    time of the calls (a call counted by the launches of ``count_symbol``),
    %.  ``work(b, s, h, d, element_bytes)`` gives the call's (FLOPs, bytes)."""
    calls = run.trace.count_where(lambda n: trace.symbol(n) == count_symbol)
    if calls == 0:
        return None
    seconds = run.trace.seconds_where(lambda n: trace.attention_family(n) == family) / calls
    b, s, h, d = run.entry.b1_shape()
    dtype = run.cell.config["dtype"]
    f, nbytes = work(b, s, h, d, flops.ELEMENT_BYTES[dtype])
    return 100.0 * flops.least_seconds(f, nbytes, dtype) / seconds


def per_unit_ms(run, pred: Callable[[str], bool]) -> Optional[float]:
    """Device ms per unit of work in the operations ``pred`` takes."""
    if run.units == 0 or not run.trace.ops:
        return None
    return 1e3 * run.trace.seconds_where(pred) / run.units
