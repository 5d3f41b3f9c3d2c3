"""Logging and phase annotation (counterpart of ``s2v_tpu/utils/logging.py``).

``get_logger`` configures the port's root logger ``s2v_torch`` once: one
handler on standard error, the level from ``S2V_TORCH_LOG_LEVEL`` (default
``INFO``).  ``phase("denoise")`` marks a pipeline phase in ``torch.profiler``
traces (``record_function``), and ``progress`` is a tqdm-free progress line
for host loops.
"""

from __future__ import annotations

import contextlib
import logging
import os
import sys
import time
from typing import Iterator

LEVEL_VARIABLE = "S2V_TORCH_LOG_LEVEL"
_FORMAT = "%(asctime)s [%(levelname)s] %(name)s: %(message)s"
_configured = False


class _StderrHandler(logging.StreamHandler):
    """Writes to ``sys.stderr`` as it is when the record is emitted, so a
    stream swapped after the handler was made (a test's capture) gets it."""

    @property
    def stream(self):
        return sys.stderr

    @stream.setter
    def stream(self, _value):
        pass


def get_logger(name: str = "s2v_torch") -> logging.Logger:
    global _configured
    if not _configured:
        handler = _StderrHandler()
        handler.setFormatter(logging.Formatter(_FORMAT))
        root = logging.getLogger("s2v_torch")
        root.addHandler(handler)
        root.setLevel(os.environ.get(LEVEL_VARIABLE, "INFO").upper())
        root.propagate = False
        _configured = True
    return logging.getLogger(name)


@contextlib.contextmanager
def phase(name: str, log: bool = False) -> Iterator[None]:
    """Mark a pipeline phase for ``torch.profiler`` traces; ``log=True``
    also logs its host-clock seconds."""
    import torch

    t0 = time.perf_counter()
    with torch.profiler.record_function(name):
        yield
    if log:
        get_logger().info("%s: %.2fs", name, time.perf_counter() - t0)


class progress:
    """Minimal tqdm-free progress reporter for host-side loops."""

    def __init__(self, total: int, desc: str = ""):
        self.total = total
        self.desc = desc
        self.n = 0
        self._t0 = time.perf_counter()

    def update(self, k: int = 1):
        self.n += k
        dt = time.perf_counter() - self._t0
        sys.stderr.write(f"\r{self.desc} {self.n}/{self.total} [{dt:.0f}s]")
        if self.n >= self.total:
            sys.stderr.write("\n")
        sys.stderr.flush()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False
