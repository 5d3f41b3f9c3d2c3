"""attention_ms.<entry>: device busy ms per unit of work in the program's
``s2v.attention`` spans (the attention backend's call: B1, or B4 and the
global queries' B1 call, and B1's M0 bound, its children included), from
the spans' CUDA events less the window's idle inside them
(``benchmark/spans.py``)."""

from benchmark import spans


def read(run):
    return spans.device_ms_per_unit(run, "s2v.attention")
