"""gate_ms.<entry>: device busy ms per unit of work in the program's
``s2v.gate`` spans (the slices of a sublayer's joint output and the three
streams' gated residual adds, two a block), from the spans' CUDA events
less the window's idle inside them (``benchmark/spans.py``)."""

from benchmark import spans


def read(run):
    return spans.device_ms_per_unit(run, "s2v.gate")
