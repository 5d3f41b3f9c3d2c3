"""The fp32 forms of kernels B1, B2 and B4-B7: CUDA C++ kernels for Hopper on
tensor cores as 3xTF32.

The JAX package's kernels compute in their inputs' own type, fp32 included
(``s2v_tpu/ops/pallas/flash_attention.py:106,163``, and so do the banded
and backward kernels), and both CLIs offer ``--dtype float32``.  These
kernels give the port's wrappers the same: ``flash_attention``,
``flash_attention_bwd``, ``banded_flash_attention(_local)`` and
``banded_flash_attention(_local)_bwd`` launch them for fp32 tensors on the
card (their launches count as ``float32`` launches).  Two sources, built
with ``nvcc`` for ``sm_90a`` into ``build/`` on the first fp32 call and
bound with ``ctypes``:

  * ``csrc/attention_f32.cu``, one forward over a key range per 128-query
    block: ``[0, Skv)`` for B1 (online and bounded softmax, lse, key pad
    mask), the global keys and the frame's window for B4's video queries,
    the same at a runtime frame offset for B6; and B3's fp32 main kernel
    (int8 logits, fp32 P·V; ``kernels/int8_attention.py`` calls it);
  * ``csrc/attention_f32_bwd.cu``, a pre-pass (lse·log2 e and D =
    rowsum(dO ∘ o)), a dq kernel and a dk/dv kernel over the same ranges
    for B2, B5 and B7.

Every product is ``wgmma`` m64nNk8 tf32 as 3xTF32 (``csrc/attention_f32.cuh``):
x = big + small with both halves rounded to tf32, and a·b ≈ small·big +
big·small + big·big in fp32, about fp32's precision where one TF32 pass keeps
about three decimal digits.  Each call's pre-pass splits every operand read
from memory once, into big and small planes (row planes, and transposed
planes for the products that reduce over the sequence, since tf32 ``wgmma``
reads K-major operands only) in a workspace the launcher allocates
(:func:`fwd_planes`, :func:`bwd_planes`); TMA brings their tiles to the
tensor cores, and the kernels split only P and dS, which they make.
Softmax and sums are fp32.  Nothing is cast down to bf16 on this route.

Bounds on an H100 SXM (TF32 dense peak 495 TFLOP/s; the operation counts
of the bf16 rows): B1 at the main shape 18.2 ms, B2 at the training shape
22.7 ms, B4's banded launch 7.3 ms; 3xTF32 triples each (the "3-pass
floor").

:func:`flash_attention_f32_blocked`, :func:`flash_attention_bwd_f32_blocked`,
:func:`banded_f32_blocked` and :func:`banded_bwd_f32_blocked` emulate the
kernels' schedules in PyTorch on any device (tf32 rounding done on the fp32
bits, the kernels' tiles in their order: 64 keys a forward tile, 32 keys a
dq tile, 32 queries a dk/dv tile); the CPU tests hold them to the plain
versions and to JAX, the card's checks hold the kernels to them.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import torch

from s2v_torch.kernels import native
from s2v_torch.kernels.native import F32, I32, I64, PTR, STREAM, ptr
from s2v_torch.utils import native_build

SOURCE = native_build.CSRC_DIR / "attention_f32.cu"
BWD_SOURCE = native_build.CSRC_DIR / "attention_f32_bwd.cu"
# rows a block owns (queries; keys in the dk/dv kernel)
KERNEL_BLOCK_ROWS = 128
# keys per tile of the forward
KERNEL_ROWS = 64
# keys per tile of the dq kernel, queries per tile of the dk/dv kernel
BWD_TILE_ROWS = 32
# a range's tiles start at its first row rounded down to this (the transposed
# planes' TMA boxes start on 16-byte boundaries); rows before the range are masked
TILE_ALIGN = 4
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
NEG_INF = -1e30
# the parts of one backward call, a bit mask of the C entry point
PART_PREPASS, PART_DQ, PART_DKV = 1, 2, 4
ALL_PARTS = PART_PREPASS | PART_DQ | PART_DKV
_BAND = [I32] * 8  # the band arguments of _band_args
LIB = native_build.Library(SOURCE, {
    "s2v_attention_f32_fwd": [PTR] * 8 + [I32] * 4 + [I64] * 12 + [I32, F32, I32] + _BAND + [STREAM],
    "s2v_flash_attention_qk_int8_fwd_f32": [PTR] * 6 + [I32] * 4 + [I64] * 6 + [STREAM],
    "s2v_attention_f32_fwd_smem_bytes": [],
    "s2v_flash_attention_qk_int8_fwd_f32_smem_bytes": [],
    "s2v_attention_f32_fwd_planes": [I32] * 4,
    "s2v_flash_attention_qk_int8_fwd_f32_planes": [I32] * 3,
}, restype={"s2v_attention_f32_fwd_planes": I64, "s2v_flash_attention_qk_int8_fwd_f32_planes": I64})
BWD_LIB = native_build.Library(BWD_SOURCE, {
    "s2v_attention_f32_bwd": [PTR] * 11 + [I32] * 4 + [I64] * 24 + [I32, F32, I32] + _BAND + [STREAM],
    "s2v_attention_f32_bwd_smem_bytes": [],
    "s2v_attention_f32_bwd_planes": [I32] * 4,
}, restype={"s2v_attention_f32_bwd_planes": I64})


def smem_bytes() -> dict:
    """Dynamic shared memory of the forward, of B3's fp32 kernel and of the
    dk/dv kernel (the backward's largest)."""
    return {"fwd": LIB.entry("s2v_attention_f32_fwd_smem_bytes")(),
            "int8_fwd": LIB.entry("s2v_flash_attention_qk_int8_fwd_f32_smem_bytes")(),
            "bwd": BWD_LIB.entry("s2v_attention_f32_bwd_smem_bytes")()}


def _band_args(band) -> List[int]:
    """The C entries' band arguments: a ``BandGeometry`` (B4: the whole clip,
    B6/B7: one shard) or None (B1/B2)."""
    if band is None:
        return [0] * 8
    return [1, band.global_len, band.tokens_per_frame, band.n_frames, band.span, band.window, band.frame_offset,
            band.local_frames]


def fwd_planes(q, k) -> torch.Tensor:
    """The forward's planes workspace (q's and k's row planes, v's transposed
    planes; fp32, the size the C entry gives), written by the call's
    pre-pass."""
    b, sq, h, _ = q.shape
    return torch.empty(LIB.entry("s2v_attention_f32_fwd_planes")(b, h, sq, k.shape[1]), dtype=torch.float32,
                       device=q.device)


def launch_fwd(q, k, v, o, lse, mask, m0_log2, scale_log2: float, bounded: bool, band=None) -> None:
    """One launch of the forward (its planes pre-pass, then the kernel) on
    fp32 ``[B, S, H, 64]`` views (rows 16-byte aligned): q the call's query
    rows (a band's: its video rows, frame by frame), k and v every key.
    ``lse`` (or None) is a ``[B, H, *]`` view whose rows may be longer than
    q's (B4 writes its video part of the whole lse); ``mask`` (or None) one
    byte per key; ``m0_log2`` a device scalar in bounded mode.  Raises on a
    launch error; counts nothing (the wrappers count)."""
    b, sq, h, _ = q.shape
    lse_ld = lse.stride(1) if lse is not None else 0
    strides = [s for t in (q, k, v, o) for s in t.stride()[:3]]
    planes = fwd_planes(q, k)
    native.launch(LIB, "s2v_attention_f32_fwd", q.device, ptr(q), ptr(k), ptr(v), ptr(o), ptr(lse), ptr(mask),
                  ptr(m0_log2), ptr(planes), b, h, sq, k.shape[1], *strides, lse_ld, scale_log2, int(bounded),
                  *_band_args(band))


def launch_int8_fwd(q_i8, k_i8, v, o, dq) -> None:
    """One launch of kernel B3's fp32 main kernel (v's planes pre-pass, then
    the kernel): int8 q_i8, k_i8 contiguous ``[B, S, H, 64]`` (the int8
    pre-pass's), fp32 v and o (rows 16-byte aligned), ``dq`` the pre-pass's
    device scalar.  Raises on a launch error; counts nothing."""
    b, sq, h, _ = q_i8.shape
    planes = torch.empty(LIB.entry("s2v_flash_attention_qk_int8_fwd_f32_planes")(b, h, v.shape[1]),
                         dtype=torch.float32, device=v.device)
    native.launch(LIB, "s2v_flash_attention_qk_int8_fwd_f32", v.device, ptr(q_i8), ptr(k_i8), ptr(v), ptr(o),
                  ptr(dq), ptr(planes), b, h, sq, k_i8.shape[1], *v.stride()[:3], *o.stride()[:3])


def bwd_workspace(q) -> torch.Tensor:
    """The backward's fp32 workspace ``[2, B·H, Sq]`` (lse·log2 e, D)."""
    b, sq, h, _ = q.shape
    return torch.empty((2, b * h, sq), dtype=torch.float32, device=q.device)


def bwd_planes(q, k) -> torch.Tensor:
    """The backward's planes workspace (the row planes of q, dO, k and v, the
    transposed planes of k, q and dO; fp32, the size the C entry gives),
    written by the pre-pass part."""
    b, sq, h, _ = q.shape
    return torch.empty(BWD_LIB.entry("s2v_attention_f32_bwd_planes")(b, h, sq, k.shape[1]), dtype=torch.float32,
                       device=q.device)


def launch_bwd(q, k, v, o, g, lse, dq, dk, dv, scale: float, band=None, workspace=None, planes=None,
               parts: int = ALL_PARTS) -> None:
    """Launch ``parts`` of one backward on fp32 views: q, o, g (dO), dq the
    call's query rows, k, v, dk, dv every key, ``lse`` a ``[B, H, *]`` view
    of the forward's (natural log) for the query rows.  The dq and dk/dv
    parts read ``workspace`` and ``planes`` as the pre-pass part wrote them
    (a call without them runs all three parts).  Raises on a launch error."""
    b, sq, h, _ = q.shape
    workspace = bwd_workspace(q) if workspace is None else workspace
    planes = bwd_planes(q, k) if planes is None else planes
    strides = [s for t in (q, k, v, o, g, dq, dk, dv) for s in t.stride()[:3]]
    native.launch(BWD_LIB, "s2v_attention_f32_bwd", q.device,
                  *(ptr(t) for t in (q, k, v, o, g, lse, workspace, planes, dq, dk, dv)), b, h, sq, k.shape[1],
                  *strides, lse.stride(1), scale, int(parts), *_band_args(band))


# ---------------------------------------------------------------------------
# The kernels' schedules, emulated
# ---------------------------------------------------------------------------


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> the nearest tf32 value (ties away from zero), on the bits as
    the kernels round: add half a unit of the 13 dropped bits, clear them
    (int32 arithmetic wraps as the kernel's uint32 does)."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & -8192).view(torch.float32)


def split_tf32(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    big = tf32_round(x)
    return big, tf32_round(x - big)


def mm_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the kernels take it: small_a·big_b + big_a·small_b +
    big_a·big_b, each product of tf32 values in fp32 (callers run it with
    TF32 matmuls off, as the smoke and the CPU do)."""
    ab, as_ = split_tf32(a)
    bb, bs = split_tf32(b)
    return torch.matmul(as_, bb) + torch.matmul(ab, bs) + torch.matmul(ab, bb)


def _range_tiles(lo: int, end: int, tile: int):
    """The tiles of keys (or queries) ``[lo, end)`` as the kernels walk them:
    ``(lo, end)`` slices of tiles that start at ``lo`` rounded down to
    :data:`TILE_ALIGN` (the kernels mask the rows before ``lo``)."""
    return [(max(kb, lo), min(kb + tile, end)) for kb in range(lo - lo % TILE_ALIGN, end, tile)]


def _frame_groups(band, n_rows: int, n_keys: int, tile: int):
    """(row_lo, row_hi, key slices) of each group of query rows that shares
    one key walk: all rows over ``[0, n_keys)`` without a band, else each
    frame of the call over its global keys and window, walked as one range
    when they touch (``csrc/band.cuh``'s walk, the window's tiles aligned as
    :func:`_range_tiles` aligns them)."""
    if band is None:
        return [(0, n_rows, _range_tiles(0, n_keys, tile))]
    g, tpf = band.global_len, band.tokens_per_frame
    groups = []
    for fl in range(band.local_frames):
        win_lo = g + band.window_start(band.frame_offset + fl) * tpf
        win_hi = win_lo + band.span * tpf
        ranges = [(0, win_hi)] if win_lo == g else [(0, g), (win_lo, win_hi)]
        groups.append((fl * tpf, (fl + 1) * tpf, [t for lo, end in ranges for t in _range_tiles(lo, end, tile)]))
    return groups


def _fwd_schedule(q, k, v, scale, band=None, key_pad_mask=None, m0_log2=None):
    """The forward kernel on query rows ``q`` ``[B, R, H, d]`` against k, v:
    64-key tiles in walk order (:func:`_frame_groups`), 3xTF32 products, an
    fp32 softmax in log2 units, online (``m0_log2`` None) or bounded.
    Returns o ``[B, H, R, d]`` (divided by l, 0 where l = 0) and the lse:
    natural, or log l in bounded mode; -1e30 where l = 0."""
    c = scale * LOG2E
    qf, kf, vf = (x.float().transpose(1, 2) for x in (q, k, v))  # [B, H, *, d]
    valid = None if key_pad_mask is None else ~key_pad_mask.to(device=q.device, dtype=torch.bool)
    outs, lses = [], []
    for r0, r1, tiles in _frame_groups(band, q.shape[1], k.shape[1], KERNEL_ROWS):
        qt = qf[:, :, r0:r1]
        bounded = m0_log2 is not None
        m = qt.new_full(qt.shape[:-1], NEG_INF) if not bounded else None
        l = qt.new_zeros(qt.shape[:-1])
        o = torch.zeros_like(qt)
        for kb, ke in tiles:
            s = mm_3xtf32(qt, kf[:, :, kb:ke].transpose(-1, -2))
            if valid is not None:
                s = s.masked_fill(~valid[kb:ke], float("-inf"))
            if bounded:
                p = torch.exp2(s * c - m0_log2)
            else:
                m_new = torch.maximum(m, s.amax(-1) * c)
                alpha = torch.exp2(m - m_new)
                p = torch.exp2(s * c - m_new[..., None])
                l, o, m = l * alpha, o * alpha[..., None], m_new
            l = l + p.sum(-1)
            o = o + mm_3xtf32(p, vf[:, :, kb:ke])
        pos = l > 0
        outs.append(torch.where(pos[..., None], o / torch.where(pos, l, torch.ones_like(l))[..., None],
                                torch.zeros_like(o)))
        lse = torch.log(torch.where(pos, l, torch.ones_like(l))) + (0.0 if bounded else m * LN2)
        lses.append(torch.where(pos, lse, torch.full_like(lse, NEG_INF)))
    return torch.cat(outs, dim=2), torch.cat(lses, dim=-1)


def flash_attention_f32_blocked(q, k, v, scale=None, return_lse=False, key_pad_mask=None, softmax_mode="online"):
    """B1's fp32 kernel emulated: ``flash_attention``'s contract on fp32 q,
    k, v (bounded modes offset by the same M0 and re-run online below the
    same underflow guard, -55)."""
    from s2v_torch.kernels.flash_attention import _bound_m0

    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if softmax_mode == "online":
        o, lse = _fwd_schedule(q, k, v, scale, key_pad_mask=key_pad_mask)
    else:
        use_exp2 = softmax_mode == "bounded_exp2"
        m0 = _bound_m0(q, k, scale * (LOG2E if use_exp2 else 1.0))
        o, logl = _fwd_schedule(q, k, v, scale, key_pad_mask=key_pad_mask,
                                m0_log2=float(m0 if use_exp2 else m0 * LOG2E))
        if float(logl.amin()) < -55.0:
            return flash_attention_f32_blocked(q, k, v, scale, return_lse, key_pad_mask, "online")
        lse = logl + float(m0 * LN2 if use_exp2 else m0)
    o = o.transpose(1, 2).to(q.dtype)
    return (o, lse) if return_lse else o


def banded_f32_blocked(q, k, v, band, scale=None, return_lse=False):
    """B4's/B6's fp32 kernel emulated on the call's video query rows ``q``
    (B4: ``q[:, G:]`` with ``band`` the whole clip's geometry; B6: the
    shard's rows with its ``BandGeometry.shard``): o ``[B, R, H, d]`` in q's
    dtype and the natural-log lse ``[B, H, R]``."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    o, lse = _fwd_schedule(q, k, v, scale, band=band)
    o = o.transpose(1, 2).to(q.dtype)
    return (o, lse) if return_lse else o


def _bwd_schedule(q, k, v, o, lse, g, scale, band=None):
    """The backward kernels on query rows q (o, dO, lse ``[B, H, R]`` the
    same rows) against k, v: the dq kernel's walk over 32-key tiles per
    frame group, the dk/dv kernel's over 32-query tiles from the first row
    that attends each key range; 3xTF32 products, fp32 sums, P from
    lse·log2 e.  Returns dq ``[B, H, R, d]`` and dk, dv ``[B, H, S, d]``,
    scaled, fp32."""
    c = scale * LOG2E
    qf, kf, vf, gf = (x.float().transpose(1, 2) for x in (q, k, v, g))
    delta = (g.float() * o.float()).sum(-1).transpose(1, 2)  # [B, H, R], the pre-pass
    lse2 = lse.float() * LOG2E
    n_rows, n_keys = q.shape[1], k.shape[1]
    real = n_rows if band is None else max(0, min(band.local_frames, band.n_frames - band.frame_offset)) \
        * band.tokens_per_frame

    dq = torch.zeros_like(qf)
    for r0, r1, tiles in _frame_groups(band, n_rows, n_keys, BWD_TILE_ROWS):
        if r0 >= real:
            continue  # a dummy frame: dq = 0
        for kb, ke in tiles:
            kt, vt = kf[:, :, kb:ke], vf[:, :, kb:ke]
            p = torch.exp2(mm_3xtf32(qf[:, :, r0:r1], kt.transpose(-1, -2)) * c - lse2[:, :, r0:r1, None])
            dp = mm_3xtf32(gf[:, :, r0:r1], vt.transpose(-1, -2))
            dq[:, :, r0:r1] += mm_3xtf32(p * (dp - delta[:, :, r0:r1, None]), kt)

    if band is None:
        ranges = [(0, n_keys, 0, n_rows)]
    else:
        tpf, off = band.tokens_per_frame, band.frame_offset
        ranges = [(0, band.global_len, 0, real)]
        for fk in range(band.n_frames):
            f_lo, f_hi = band.inverse_band(fk)
            lo, hi = max(f_lo, off), min(f_hi, off + band.local_frames - 1)
            q_lo = (lo - off) * tpf
            k0 = band.global_len + fk * tpf
            ranges.append((k0, k0 + tpf, q_lo, (hi - off + 1) * tpf if hi >= lo else q_lo))
    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    for k0, k1, q_lo, q_hi in ranges:
        for qb, qe in _range_tiles(q_lo, q_hi, BWD_TILE_ROWS):
            qt, gt = qf[:, :, qb:qe], gf[:, :, qb:qe]
            pt = torch.exp2(mm_3xtf32(kf[:, :, k0:k1], qt.transpose(-1, -2)) * c - lse2[:, :, None, qb:qe])
            dpt = mm_3xtf32(vf[:, :, k0:k1], gt.transpose(-1, -2))
            dv[:, :, k0:k1] += mm_3xtf32(pt, gt)
            dk[:, :, k0:k1] += mm_3xtf32(pt * (dpt - delta[:, :, None, qb:qe]), qt)
    return dq * scale, dk * scale, dv


def flash_attention_bwd_f32_blocked(q, k, v, o, lse, g, scale=None):
    """B2's fp32 kernels emulated: ``flash_attention_bwd``'s contract."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    dq, dk, dv = _bwd_schedule(q, k, v, o, lse, g, scale)
    return tuple(x.transpose(1, 2).to(t.dtype) for x, t in ((dq, q), (dk, k), (dv, v)))


def banded_bwd_f32_blocked(q, k, v, o, lse, g, band, scale=None):
    """B5's/B7's fp32 kernels emulated on the call's video query rows (q, o,
    g ``[B, R, H, d]``, lse ``[B, H, R]``) against every key: dq of the
    rows, and the partial dk, dv of every key from these rows only."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    dq, dk, dv = _bwd_schedule(q, k, v, o, lse, g, scale, band=band)
    return tuple(x.transpose(1, 2).to(t.dtype) for x, t in ((dq, q), (dk, k), (dv, v)))

