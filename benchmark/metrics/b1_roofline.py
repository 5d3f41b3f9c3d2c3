"""b1_roofline.<entry>: B1's least time at the window's shape (the larger
of its operations over the peak and its bytes over the bandwidth) over the
mean device time of one ``flash_fwd_kernel`` launch, %."""

from benchmark import flops, readers


def read(run):
    return readers.roofline(run, "b1", "flash_fwd_kernel",
                            lambda b, s, h, d, e: (flops.b1_flops(b, s, h, d), flops.b1_bytes(b, s, h, d, e)))
