"""matmul_ms.<entry>: device ms per unit of work in library products
(cuBLAS, CUTLASS)."""

from benchmark import readers, trace


def read(run):
    return readers.per_unit_ms(run, trace.is_matmul)
