"""qk_rope_ms.<entry>: device busy ms per unit of work in the program's
``s2v.qk_rope`` spans (the q/k LayerNorms, the rotary embedding and the
fp16 upcast before attention), from the spans' CUDA events less the
window's idle inside them (``benchmark/spans.py``)."""

from benchmark import spans


def read(run):
    return spans.device_ms_per_unit(run, "s2v.qk_rope")
