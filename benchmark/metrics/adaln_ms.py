"""adaln_ms.<entry>: device busy ms per unit of work in the program's
``s2v.adaln`` spans (each block's two adaLN-Zero modulations,
fp32-statistics LayerNorms, scales and shifts of the three streams, and
their join into the joint sequence), from the spans' CUDA events less the
window's idle inside them (``benchmark/spans.py``)."""

from benchmark import spans


def read(run):
    return spans.device_ms_per_unit(run, "s2v.adaln")
