"""b2_roofline.<entry>: B2's least time at the window's shape over the mean
device time of one backward call (its pre-pass, dq and dk/dv kernels
together, calls counted by ``flash_bwd_dq_kernel``), %."""

from benchmark import flops, readers


def read(run):
    return readers.roofline(run, "b2", "flash_bwd_dq_kernel",
                            lambda b, s, h, d, e: (flops.b2_flops(b, s, h, d), flops.b2_bytes(b, s, h, d, e)))
