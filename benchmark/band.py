"""Frozen work counts of the windowed attention: operations and bytes of the
banded kernel B4 and of the B1 call that takes the global queries, from a
band's geometry alone (``[G global | F frames of tpf tokens]``, half-width
``w`` latent frames, each video query over the G global keys and a window
of ``span = min(2w + 1, F)`` frames).  They sit with the benchmark, not the
program, so no change to the program can move them; counted as
``benchmark/flops.py`` counts B1: two products (QKᵀ and PV) of ``2·d`` per
(query, key) pair and head, operands read and written once."""

from __future__ import annotations

from typing import Tuple


def video_queries(frames: int, tpf: int) -> int:
    return frames * tpf


def band_keys(global_len: int, tpf: int, frames: int, w: int) -> int:
    """Keys each video query attends: the global ones and its window."""
    return global_len + min(2 * w + 1, frames) * tpf


def b4_flops(b: int, h: int, d: int, global_len: int, tpf: int, frames: int, w: int) -> float:
    return 4.0 * b * h * d * video_queries(frames, tpf) * band_keys(global_len, tpf, frames, w)


def b4_bytes(b: int, h: int, d: int, global_len: int, tpf: int, frames: int, elem: int) -> float:
    """The video queries read and their outputs written, every key and
    value read once, and the fp32 log-sum-exp row of the video queries."""
    qv, s = video_queries(frames, tpf), global_len + video_queries(frames, tpf)
    return float(b * h * d * elem * (2 * qv + 2 * s) + b * h * qv * 4)


def global_flops(b: int, h: int, d: int, global_len: int, tpf: int, frames: int) -> float:
    """The B1 call of the global queries over the whole sequence."""
    return 4.0 * b * h * d * global_len * (global_len + video_queries(frames, tpf))


def attention_flops(b: int, h: int, d: int, global_len: int, tpf: int, frames: int, w: int) -> Tuple[float, float]:
    """(B4's, the global B1 call's) operations of one windowed attention."""
    return b4_flops(b, h, d, global_len, tpf, frames, w), global_flops(b, h, d, global_len, tpf, frames)
