"""optimizer_ms.<entry>: device busy ms per unit of work in the program's
``s2v.train.optimizer`` spans (the global-norm clip and the AdamW update),
from the spans' CUDA events less the window's idle inside them
(``benchmark/spans.py``)."""

from benchmark import spans


def read(run):
    return spans.device_ms_per_unit(run, "s2v.train.optimizer")
