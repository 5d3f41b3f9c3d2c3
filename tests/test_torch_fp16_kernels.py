"""Kernels B3-B7 in fp16 (the 2b family), on the CPU: their plain versions
and the emulations of the kernels' schedules (``*_blocked``, which round P,
and in the backward dS, to fp16 as the fp16 kernels do) on fp16 inputs,
against the JAX package's path for fp16, which upcasts q/k/v (and dO) to
fp32 before its Pallas kernel (``s2v_tpu/ops/attention.py:208-214``; here in
interpret mode) and casts the result back to fp16.

Tolerance: the card's limits for a kernel against its plain version (ROADMAP
C.1), max|x − x_ref| ≤ 2⁻⁶·max|x_ref| and relative L2 < 1e-2, with the max
error at least one fp16 subnormal step (2⁻²⁴) for gradients that small.
The banded backward runs at dO 2⁻¹⁴ of unit normal, a training step's scale
(no loss scaler): the fp32 dS there sits near fp16's flush point, so without
the kernels' 2^e scale before dS's rounding dq and dk leave the limits.
The card holds the kernels to the same versions (``tests/test_torch_gpu.py``,
``chip_smoke.py``)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from _torch_parity import band_inputs
from s2v_tpu.ops.pallas import banded_attention as j_fwd
from s2v_tpu.ops.pallas import banded_attention_bwd as j_bwd
from s2v_tpu.ops.pallas import int8_attention as j_int8
from s2v_torch.kernels.banded_attention import (
    banded_flash_attention,
    banded_flash_attention_blocked,
    banded_flash_attention_local,
)
from s2v_torch.kernels.banded_attention_bwd import (
    band_ds_exponent,
    banded_flash_attention_bwd,
    banded_flash_attention_bwd_blocked,
    banded_flash_attention_local_bwd,
)
from s2v_torch.kernels.banded_attention import band_geometry
from s2v_torch.kernels.flash_attention_bwd import DS_BOUND_LOG2
from s2v_torch.kernels.int8_attention import flash_attention_qk_int8, flash_attention_qk_int8_blocked

MAX_REL, L2_REL = 2.0 ** -6, 1e-2
FP16_SUBNORMAL_ULP = 2.0 ** -24

# (B, H, G, tpf, F, w): the main shape's remainders mod 128 and a clamped window
GEOMETRIES = {"main_remainders": (1, 2, 168, 198, 5, 2), "clamped_batch2": (2, 2, 24, 20, 5, 1)}


def _assert_close(got, want, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    diff = np.abs(got - want)
    assert diff.max() <= max(MAX_REL * np.abs(want).max(), FP16_SUBNORMAL_ULP), what
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < L2_REL, what


def _layer_norm(x):
    return (x - x.mean(-1, keepdims=True)) / np.sqrt(x.var(-1, keepdims=True) + 1e-6)


def _fp16(*xs):
    """numpy fp32 -> (fp16 torch tensors, the fp32 upcast of the same values for JAX)."""
    halves = [torch.from_numpy(np.ascontiguousarray(x)).half() for x in xs]
    return halves, [jnp.asarray(t.float().numpy()) for t in halves]


def _jax_fp16(x):
    """JAX's fp32 result cast back to fp16, as its attention does for fp16 storage."""
    return np.asarray(x).astype(np.float16).astype(np.float32)


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_banded_fp16_matches_jax_upcast(geometry):
    """B4 in fp16: the plain version (the CPU branch of the wrapper) and the
    schedule's emulation return fp16 within the limits of JAX's upcast path."""
    b, h, g, tpf, f, w = GEOMETRIES[geometry]
    (tq, tk, tv), jqkv = _fp16(*band_inputs(b, h, g, tpf, f, seed=f * tpf + g, d=64, n=3))
    want = _jax_fp16(j_fwd.banded_flash_attention(*jqkv, g, tpf, w, interpret=True))
    for name, o in (("plain", banded_flash_attention(tq, tk, tv, g, tpf, w)),
                    ("schedule", banded_flash_attention_blocked(tq, tk, tv, g, tpf, w))):
        assert o.dtype == torch.float16 and o.shape == tq.shape
        _assert_close(o.float().numpy(), want, name)


@pytest.mark.parametrize("ring", [1, 2])
def test_banded_local_fp16_matches_jax_upcast(ring):
    """B6 in fp16 at every offset of a ring: plain version and schedule
    against JAX's local kernel on the upcast."""
    b, h, g, tpf, f, w = GEOMETRIES["main_remainders"]
    q, k, v = band_inputs(b, h, g, tpf, f, seed=11, d=64, n=3)
    (tq, tk, tv), (jq, jk, jv) = _fp16(q, k, v)
    f_loc = -(-f // ring)
    for rank in range(ring):
        off = rank * f_loc
        n = min(f_loc, f - off)
        rows = slice(g + off * tpf, g + (off + n) * tpf)
        want = _jax_fp16(j_fwd.banded_flash_attention_local(jq[:, rows], jk, jv, g, tpf, w,
                                                            jnp.array([off], jnp.int32), f, interpret=True))
        for name, o in (("plain", banded_flash_attention_local(tq[:, rows], tk, tv, g, tpf, w, off, f)),
                        ("schedule", banded_flash_attention_blocked(tq[:, rows], tk, tv, g, tpf, w,
                                                                    frame_offset=off, n_frames_total=f))):
            assert o.dtype == torch.float16
            _assert_close(o.float().numpy(), want, f"rank {rank} {name}")


def _small_do_inputs(seed):
    """fp16 q/k (layer-normed, as after qk-norm), v, and dO at 2^-14 of unit
    normal: the video queries see G + 3·tpf = 1,000 keys, so the fp32 dS sits
    near fp16's flush point (2^-25)."""
    b, h, g, tpf, f, w = 1, 2, 250, 250, 5, 1
    rng = np.random.RandomState(seed)
    s = g + f * tpf
    q, k, v = (rng.randn(b, s, h, 64).astype(np.float32) for _ in range(3))
    q, k = _layer_norm(q), _layer_norm(k)
    do = (rng.randn(b, s, h, 64) * 2.0 ** -14).astype(np.float32)
    return (g, tpf, f, w), _fp16(q, k, v, do)


def test_banded_bwd_fp16_keeps_small_gradients():
    """B5 in fp16 at a training step's dO: the schedule's emulation (dS
    scaled by 2^e of ``band_ds_exponent`` before its fp16 rounding) and the
    plain version give dq, dk, dv within the limits of JAX's Pallas backward
    on the fp32 upcast, cast back to fp16.  Rounded unscaled, the emulation's
    dS flushes and dq, dk leave the limits."""
    (g, tpf, f, w), ((tq, tk, tv, tdo), (jq, jk, jv, jdo)) = _small_do_inputs(5)
    o, lse = banded_flash_attention(tq, tk, tv, g, tpf, w, return_lse=True)
    o_j, lse_j = j_fwd.banded_flash_attention(jq, jk, jv, g, tpf, w, interpret=True, return_lse=True)
    want_jax = j_bwd.banded_flash_attention_bwd(jq, jk, jv, o_j, lse_j, jdo, g, tpf, w, interpret=True)
    got = banded_flash_attention_bwd_blocked(tq, tk, tv, o, lse, tdo, g, tpf, w)
    plain = banded_flash_attention_bwd(tq, tk, tv, o, lse, tdo, g, tpf, w)
    for name, a, p, wj in zip(("dq", "dk", "dv"), got, plain, want_jax):
        assert a.dtype == torch.float16 and p.dtype == torch.float16 and bool((a != 0).any())
        _assert_close(a.float().numpy(), p.float().numpy(), f"{name} schedule vs plain")
        _assert_close(a.float().numpy(), _jax_fp16(wj), f"{name} schedule vs JAX")
        _assert_close(p.float().numpy(), _jax_fp16(wj), f"{name} plain vs JAX")


def test_banded_local_bwd_fp16_keeps_small_gradients():
    """B7 in fp16 at the same dO, shard by shard of a 2-rank ring: its dq and
    partial dk, dv (emulated) against the plain version's."""
    (g, tpf, f, w), ((tq, tk, tv, tdo), _) = _small_do_inputs(6)
    o, lse = banded_flash_attention(tq, tk, tv, g, tpf, w, return_lse=True)
    f_loc = 3
    for off in (0, f_loc):
        n = min(f_loc, f - off)
        rows = slice(g + off * tpf, g + (off + n) * tpf)
        args = (tq[:, rows], tk, tv, o[:, rows], lse[..., rows].contiguous(), tdo[:, rows])
        got = banded_flash_attention_bwd_blocked(*args, g, tpf, w, frame_offset=off, n_frames_total=f)
        plain = banded_flash_attention_local_bwd(*args, g, tpf, w, off, f)
        for name, a, p in zip(("dq", "dk", "dv"), got, plain):
            assert a.dtype == torch.float16
            _assert_close(a.float().numpy(), p.float().numpy(), f"offset {off} {name}")


@pytest.mark.parametrize("log2_scale", [0, -20])
def test_band_ds_exponent_bounds_the_scaled_ds(log2_scale):
    """2^e·|dS| stays under 2^14 over the band (fp16 tops out at 65,504), e
    follows dO's scale exactly, and dummy frames' rows are not read."""
    b, h, g, tpf, f, w = GEOMETRIES["clamped_batch2"]
    q, k, v, do = (torch.from_numpy(x) for x in band_inputs(b, h, g, tpf, f, seed=4, d=64))
    do = do * 2.0 ** log2_scale
    geo = band_geometry(q.shape[1], g, tpf, w)
    o, lse = banded_flash_attention(q, k, v, g, tpf, w, return_lse=True)
    e = int(band_ds_exponent(v, do[:, g:], geo))
    qt, kt, vt, gt = (x.transpose(1, 2) for x in (q, k, v, do))
    p = torch.exp(qt @ kt.transpose(-1, -2) / 8.0 - lse[..., None])
    delta = (do * o).sum(-1).transpose(1, 2)
    ds = p * (gt @ vt.transpose(-1, -2) - delta[..., None])
    assert ds[:, :, g:].abs().max().item() * 2.0 ** e <= 2.0 ** DS_BOUND_LOG2
    shard = geo.shard(4, 2)  # frame 4 real, frame 5 a dummy
    rows = do[:, g + 4 * tpf:]
    junk = torch.cat([rows, torch.full_like(rows, 1e6)], dim=1)
    assert int(band_ds_exponent(v, junk, shard)) == int(band_ds_exponent(v, rows, shard))
    assert int(band_ds_exponent(v, junk, geo.shard(6, 2))) == 0  # the last shard of a 4-rank ring: no real frame


def test_int8_fp16_matches_jax_upcast():
    """B3 in fp16: the same int8 pre-pass (fp16 read exactly into fp32), the
    plain version and the schedule (P rounded to fp16 for P·V) against JAX's
    int8 kernel on the upcast, ragged key tail included."""
    rng = np.random.RandomState(7)
    q, k, v = (rng.randn(2, n, 2, 64).astype(np.float32) for n in (150, 170, 170))
    (tq, tk, tv), jqkv = _fp16(q, k, v)
    want = _jax_fp16(j_int8.flash_attention_qk_int8(*jqkv, block_q=64, block_k=128, interpret=True))
    for name, o in (("plain", flash_attention_qk_int8(tq, tk, tv)), ("schedule", flash_attention_qk_int8_blocked(tq, tk, tv))):
        assert o.dtype == torch.float16 and o.shape == tq.shape
        _assert_close(o.float().numpy(), want, name)
