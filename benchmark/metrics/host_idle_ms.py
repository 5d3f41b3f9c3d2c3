"""host_idle_ms.<entry>: device-idle ms per unit of work in the window's
other gaps, the part of each that the program's own spans cover on the
host, put down to the innermost span by overlap; idle under a clip's
``s2v.prologue`` counts once a clip, weighed 1 in its steps
(``benchmark/spans.py``)."""

from benchmark import spans


def read(run):
    return spans.idle_ms_per_unit(run, "host")
