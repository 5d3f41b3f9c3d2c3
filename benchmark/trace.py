"""The traced run: ``torch.profiler`` (CUPTI on the card) over the
measured window, reduced to device operations and the benchmark's own host
spans, and the arithmetic the per-layer readers share.

The window is the benchmark's ``bench.window`` span, from the host's start
of the first unit of work to its end after the last device sync.  The
device is busy where any kernel, copy or set runs (the union of their
intervals); the idle share is the rest of the window, before the first
operation and after the last included.  Kernels are told apart by their
symbols: the port's attention kernels by the names of their ``__global__``
functions, library products by the names cuBLAS and CUTLASS give theirs.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

SPAN_PREFIX = "bench."
WINDOW_SPAN = "bench.window"
DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")

# the port's attention kernels (B1-B7 and their fp32 forms), by the name of
# their __global__ function at the start of the symbol or after a space
ATTENTION_KERNELS = {
    "b1": ("flash_fwd_kernel",),
    "b2": ("flash_bwd_prepass_kernel", "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel"),
    "b3": ("s2v_i8attn_fwd_kernel", "s2v_i8attn_amax_kernel", "s2v_i8attn_quantize_kernel"),
    "b4": ("banded_fwd_kernel",),
    "b5": ("banded_bwd_prepass_kernel", "banded_bwd_dq_kernel", "banded_bwd_dkv_kernel"),
    "f32": ("fwd_kernel", "prepass_kernel", "dq_kernel", "dkv_kernel"),
}
# library products: cuBLAS (sm90_xmma_*, nvjet_*, *gemm*), CUTLASS
MATMUL_PATTERN = re.compile(r"gemm|nvjet|xmma|cutlass|cublas", re.IGNORECASE)


def symbol(name: str) -> str:
    """The function name of a demangled kernel name: ``void (anonymous
    namespace)::flash_fwd_kernel<__nv_bfloat16>(Params<...>)`` ->
    ``flash_fwd_kernel``; a name that is no C++ signature stays whole."""
    head = name.replace("(anonymous namespace)", "anonymous")
    depth, cut = 0, len(head)
    for i, ch in enumerate(head):  # the name ends at the first '(' outside template brackets
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            cut = i
            break
    head = head[:cut]
    out, depth = [], 0
    for ch in head:  # drop template arguments
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif depth == 0:
            out.append(ch)
    sym = "".join(out).strip().split(" ")[-1].split("::")[-1]
    return sym or name


def attention_family(name: str) -> Optional[str]:
    sym = symbol(name)
    for fam, syms in ATTENTION_KERNELS.items():
        if sym in syms:
            return fam
    return None


def is_matmul(name: str) -> bool:
    return attention_family(name) is None and bool(MATMUL_PATTERN.search(name))


@dataclass
class Trace:
    ops: List[Tuple[str, int, int]] = field(default_factory=list)  # device (name, start_ns, end_ns)
    spans: List[Tuple[str, int, int]] = field(default_factory=list)  # host bench.* spans
    window: Tuple[int, int] = (0, 0)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def in_window(self) -> List[Tuple[str, int, int]]:
        lo, hi = self.window
        return [(n, max(s, lo), min(e, hi)) for n, s, e in self.ops if e > lo and s < hi]

    def busy_s(self) -> float:
        return union_ns([(s, e) for _, s, e in self.in_window()]) / 1e9

    def idle_share(self) -> Optional[float]:
        """1 - busy / window, as a percentage; None without a window."""
        if self.window[1] <= self.window[0]:
            return None
        return 100.0 * (1.0 - self.busy_s() / self.window_s)

    def seconds_where(self, pred) -> float:
        return sum(e - s for n, s, e in self.in_window() if pred(n)) / 1e9

    def count_where(self, pred) -> int:
        return sum(1 for n, _, _ in self.in_window() if pred(n))

    def top_ops(self, k: int = 10) -> List[list]:
        by: Dict[str, float] = {}
        for n, s, e in self.in_window():
            sym = symbol(n) or n
            by[sym] = by.get(sym, 0.0) + (e - s) / 1e9
        return [[n, v] for n, v in sorted(by.items(), key=lambda kv: -kv[1])[:k]]

    def idle_gaps(self, k: int = 10) -> List[list]:
        """The longest stretches of the window with no device operation,
        each named by the innermost benchmark span open on the host when
        it began."""
        lo, hi = self.window
        ivs = sorted((s, e) for _, s, e in self.in_window())
        gaps, end = [], lo
        for s, e in ivs:
            if s > end:
                gaps.append((end, s))
            end = max(end, e)
        if hi > end:
            gaps.append((end, hi))
        gaps.sort(key=lambda g: -(g[1] - g[0]))
        out = []
        for g0, g1 in gaps[:k]:
            open_spans = [(s, n) for n, s, e in self.spans if s <= g0 < e]
            name = max(open_spans)[1] if open_spans else "outside the benchmark's spans"
            out.append([name, (g1 - g0) / 1e9])
        return out


def union_ns(intervals) -> int:
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def start(device):
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts, record_shapes=False, with_stack=False)
    prof.__enter__()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return prof


def stop(prof) -> Trace:
    prof.__exit__(None, None, None)
    events = prof.profiler.kineto_results.events()
    tr = Trace()
    host_names = set()
    device = []
    for e in events:
        name = e.name()
        kind = getattr(e, "activity_type", lambda: "")()
        if str(e.device_type()).endswith("CPU"):
            host_names.add(name)
            if name.startswith(SPAN_PREFIX):
                span = (name, e.start_ns(), e.start_ns() + e.duration_ns())
                tr.spans.append(span)
                if name == WINDOW_SPAN:
                    tr.window = span[1:]
        elif not kind or kind in DEVICE_ACTIVITIES:
            device.append((name, e.start_ns(), e.start_ns() + e.duration_ns()))
    # a host annotation mirrored on the device timeline is no device operation
    tr.ops = [op for op in device if op[0] not in host_names]
    return tr
