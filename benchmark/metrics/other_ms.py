"""other_ms.<entry>: device ms per unit of work in every operation that is
neither one of the port's attention kernels (B1-B7 symbols) nor a library
product, so that a fused replacement stays counted."""

from benchmark import readers, trace


def read(run):
    return readers.per_unit_ms(run, lambda n: trace.attention_family(n) is None and not trace.is_matmul(n))
