"""b4_roofline.<entry>: B4's least time at the cell's band geometry (the
larger of its operations over the peak and its bytes over the bandwidth,
``benchmark/band.py``, given by the entry's ``b4_work()``) over the mean
device time of one ``banded_fwd_kernel`` launch, %."""

from benchmark import flops, trace


def read(run):
    work = getattr(run.entry, "b4_work", None)
    calls = run.trace.count_where(lambda n: trace.symbol(n) == "banded_fwd_kernel")
    if work is None or calls == 0:
        return None
    seconds = run.trace.seconds_where(lambda n: trace.attention_family(n) == "b4") / calls
    dtype = run.cell.config["dtype"]
    f, nbytes = work()
    return 100.0 * flops.least_seconds(f, nbytes, dtype) / seconds
