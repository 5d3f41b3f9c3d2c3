"""mfu.<entry>: the model FLOPs of one unit of work (``benchmark/flops.py``;
training three forwards, remat's recompute not counted) over the unit's
seconds as the cell's end-to-end metric gives them, at the dtype's
tensor-core peak, %."""

from benchmark import flops


def read(run):
    if run.units == 0 or run.unit_s <= 0 or not run.trace.ops:
        return None
    return 100.0 * run.entry.unit_flops() / (run.unit_s * flops.PEAK_FLOPS[run.cell.config["dtype"]])
