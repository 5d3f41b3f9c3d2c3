"""idle_share.<entry>: % of the traced window (the benchmark's
``bench.window`` span) in which no operation ran on the device."""


def read(run):
    if not run.trace.ops:
        return None
    return run.trace.idle_share()
