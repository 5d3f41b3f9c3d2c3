"""sync_idle_ms.<entry>: device-idle ms per unit of work in the window's
gaps that open while the host is inside one of the program's
``s2v.sync.*`` spans (a host sync: B1's underflow guard, a copy that
waits), all of each such gap (``benchmark/spans.py``)."""

from benchmark import spans


def read(run):
    return spans.idle_ms_per_unit(run, "sync")
