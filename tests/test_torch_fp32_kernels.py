"""The fp32 forms of kernels B1, B2 and B4-B7 (ROADMAP C.1;
``s2v_torch/kernels/attention_f32.py``, ``csrc/attention_f32.cu``,
``csrc/attention_f32_bwd.cu``) on the CPU: the emulations of their 3xTF32
schedules against the JAX Pallas kernels in interpret mode in fp32 (what the
JAX package computes for fp32 inputs) and against the port's plain
versions, on the same numpy inputs; the tf32 split the kernels and the
emulations share; and the ``--dtype float32`` route, which reaches the fp32
plain versions (the CPU's stand-in for the fp32 kernels) with nothing cast
down to bf16.

Limits, the chip smoke's for the kernels: forward max|x - x_ref| <=
2^-14·max|x_ref| and relative L2 < 2e-5; backward 2^-12 and 1e-4; lse within
1e-4.  3xTF32 keeps products to ~2^-21 relative and the emulation reads
~1e-6 against both; one TF32 pass would miss these limits by 10-100x.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from _torch_parity import band_inputs
from s2v_tpu.ops.pallas import banded_attention as j_banded
from s2v_tpu.ops.pallas import banded_attention_bwd as j_banded_bwd
from s2v_tpu.ops.pallas.flash_attention import flash_attention as j_flash
from s2v_tpu.ops.pallas.flash_attention_bwd import flash_attention_bwd as j_flash_bwd
from s2v_torch.kernels import attention_f32 as af
from s2v_torch.kernels.banded_attention import (
    band_geometry,
    banded_flash_attention_local_reference,
    banded_flash_attention_reference,
    ring_shards,
)
from s2v_torch.kernels.banded_attention_bwd import (
    banded_flash_attention_bwd_reference,
    banded_flash_attention_local_bwd_reference,
)
from s2v_torch.kernels.flash_attention import flash_attention_reference
from s2v_torch.kernels.flash_attention_bwd import flash_attention_bwd_reference

FWD_MAX_REL, FWD_L2 = 2.0 ** -14, 2e-5
BWD_MAX_REL, BWD_L2 = 2.0 ** -12, 1e-4
LSE_ATOL = 1e-4
# (B, H, G, tpf, F, w): the main shape's remainders mod 64, clamped windows,
# w = 0, a window wider than the clip
GEOMETRIES = {"main_remainders": (1, 2, 168, 198, 5, 2), "clamped_batch2": (2, 2, 24, 20, 5, 1),
              "w0": (1, 2, 24, 20, 4, 0), "span_equals_F": (1, 2, 50, 40, 5, 9)}
# B6/B7 at every offset: rings with dummy frames, and a ring past the frame count
LOCAL = [("main_remainders", 4), ("clamped_batch2", 2), ("two_frames", 4)]
TWO_FRAMES = (1, 2, 24, 20, 2, 1)


def _close(got, want, bwd=False, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    max_rel, l2 = (BWD_MAX_REL, BWD_L2) if bwd else (FWD_MAX_REL, FWD_L2)
    if not np.abs(want).max():
        assert not np.abs(got).max(), what
        return
    diff = got - want
    assert np.abs(diff).max() <= max_rel * np.abs(want).max(), (what, np.abs(diff).max(), np.abs(want).max())
    assert np.linalg.norm(diff) / np.linalg.norm(want) < l2, (what, np.linalg.norm(diff) / np.linalg.norm(want))


def _t(*xs):
    return [torch.from_numpy(np.array(x)) for x in xs]


def test_tf32_split_rounds_as_the_kernels():
    """Round to nearest on the 13 dropped bits, ties away from zero (as
    ``cvt.rna``), and big + small keeps ~22 bits of x."""
    ulp = 2.0 ** -10  # tf32's unit in [1, 2)
    x = torch.tensor([1.0 + ulp / 2, 1.0 + ulp / 2 - 2.0 ** -23, -(1.0 + ulp / 2), 1.0 + 1.5 * ulp, 3.0],
                     dtype=torch.float32)
    assert af.tf32_round(x).tolist() == [1.0 + ulp, 1.0, -(1.0 + ulp), 1.0 + 2 * ulp, 3.0]
    v = torch.from_numpy(np.random.RandomState(0).randn(10000).astype(np.float32))
    big, small = af.split_tf32(v)
    assert torch.equal(af.tf32_round(big), big) and torch.equal(af.tf32_round(small), small)
    assert ((big + small - v).abs() <= v.abs() * 2.0 ** -21).all()
    assert ((big - v).abs() > v.abs() * 2.0 ** -14).any()  # one pass alone keeps ~11 bits


@pytest.mark.parametrize("mode", ["online", "bounded", "bounded_exp2"])
@pytest.mark.parametrize("sq,skv,masked", [(150, 150, False), (70, 200, False), (96, 130, True)],
                         ids=["ragged", "sq_ne_skv", "key_pad_mask"])
def test_b1_fp32_schedule_matches_pallas_and_plain(mode, sq, skv, masked):
    rng = np.random.RandomState(sq + skv)
    q, k, v = (rng.randn(1, s, 2, 64).astype(np.float32) for s in (sq, skv, skv))
    mask = None
    if masked:
        mask = np.zeros(skv, bool)
        mask[10:30] = True
        mask[-5:] = True
    o_j, lse_j = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block_q=64, block_k=64, interpret=True,
                         return_lse=True, key_pad_mask=None if mask is None else jnp.asarray(mask), softmax_mode=mode)
    tm = None if mask is None else torch.from_numpy(mask)
    o, lse = af.flash_attention_f32_blocked(*_t(q, k, v), return_lse=True, key_pad_mask=tm, softmax_mode=mode)
    o_ref, lse_ref = flash_attention_reference(*_t(q, k, v), return_lse=True, key_pad_mask=tm, softmax_mode=mode)
    assert o.dtype == torch.float32 and o.shape == (1, sq, 2, 64)
    _close(o, np.asarray(o_j), what="pallas")
    _close(o, o_ref, what="plain")
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j), atol=LSE_ATOL)
    np.testing.assert_allclose(lse.numpy(), lse_ref.numpy(), atol=LSE_ATOL)


@pytest.mark.parametrize("sq,skv", [(150, 150), (70, 200), (200, 40)])
def test_b2_fp32_schedule_matches_pallas_and_plain(sq, skv):
    rng = np.random.RandomState(sq * skv)
    q, k, v = (rng.randn(1, s, 2, 64).astype(np.float32) for s in (sq, skv, skv))
    do = rng.randn(1, sq, 2, 64).astype(np.float32)
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    o, lse = j_flash(jq, jk, jv, block_q=64, block_k=64, interpret=True, return_lse=True)
    want_jax = j_flash_bwd(jq, jk, jv, o, lse, jnp.asarray(do), block_q=64, block_k=64, interpret=True)
    args = _t(q, k, v, o, lse, do)
    got = af.flash_attention_bwd_f32_blocked(*args)
    want = flash_attention_bwd_reference(*args)
    for name, a, r, rj, x in zip(("dq", "dk", "dv"), got, want, want_jax, (q, k, v)):
        assert a.shape == x.shape and a.dtype == torch.float32
        _close(a, np.asarray(rj), bwd=True, what=f"{name} pallas")
        _close(a, r, bwd=True, what=f"{name} plain")


def _banded_emulated(q, k, v, g, tpf, w):
    """B4's fp32 path emulated: the video rows on the banded schedule, the
    global rows on B1's online schedule."""
    geo = band_geometry(q.shape[1], g, tpf, w)
    o_v, lse_v = af.banded_f32_blocked(q[:, g:], k, v, geo, return_lse=True)
    o_g, lse_g = af.flash_attention_f32_blocked(q[:, :g], k, v, return_lse=True)
    return torch.cat([o_g, o_v], 1), torch.cat([lse_g, lse_v], -1)


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_b4_b5_fp32_schedules_match_pallas_and_plain(geometry):
    b, h, g, tpf, f, w = GEOMETRIES[geometry]
    q, k, v, do = band_inputs(b, h, g, tpf, f, seed=f * tpf + g, d=64)
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    o_j, lse_j = j_banded.banded_flash_attention(jq, jk, jv, g, tpf, w, interpret=True, return_lse=True)
    tq, tk, tv, tdo = _t(q, k, v, do)
    o, lse = _banded_emulated(tq, tk, tv, g, tpf, w)
    o_ref, lse_ref = banded_flash_attention_reference(tq, tk, tv, g, tpf, w, return_lse=True)
    _close(o, np.asarray(o_j), what="B4 pallas")
    _close(o, o_ref, what="B4 plain")
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j), atol=LSE_ATOL)
    np.testing.assert_allclose(lse.numpy(), lse_ref.numpy(), atol=LSE_ATOL)

    want_jax = j_banded_bwd.banded_flash_attention_bwd(jq, jk, jv, o_j, lse_j, jnp.asarray(do), g, tpf, w,
                                                       interpret=True)
    args = _t(q, k, v, o_j, lse_j, do)
    geo = band_geometry(q.shape[1], g, tpf, w)
    dq_v, dk_v, dv_v = af.banded_bwd_f32_blocked(args[0][:, g:], args[1], args[2], args[3][:, g:],
                                                 args[4][..., g:], args[5][:, g:], geo)
    dq_g, dk_g, dv_g = af.flash_attention_bwd_f32_blocked(args[0][:, :g], args[1], args[2], args[3][:, :g],
                                                          args[4][..., :g], args[5][:, :g])
    got = (torch.cat([dq_g, dq_v], 1), dk_v + dk_g, dv_v + dv_g)
    want = banded_flash_attention_bwd_reference(*args, g, tpf, w)
    for name, a, r, rj in zip(("dq", "dk", "dv"), got, want, want_jax):
        _close(a, np.asarray(rj), bwd=True, what=f"B5 {name} pallas")
        _close(a, r, bwd=True, what=f"B5 {name} plain")


@pytest.mark.parametrize("geometry,ring", LOCAL, ids=[f"{g}-ring{r}" for g, r in LOCAL])
def test_b6_b7_fp32_schedules_match_pallas_and_plain_at_every_offset(geometry, ring):
    """Each shard of the ring, dummy frames included; on the ring of 4 over 2
    frames ranks 2 and 3 hold dummy frames only (ROADMAP A.9.4)."""
    b, h, g, tpf, f, w = TWO_FRAMES if geometry == "two_frames" else GEOMETRIES[geometry]
    f_pad, f_loc = ring_shards(f, ring)
    q, k, v, do = band_inputs(b, h, g, tpf, f_pad, seed=ring * 11 + f, d=64)
    s = g + f * tpf
    do[:, s:] = 0.0
    k, v = k[:, :s], v[:, :s]
    geo = band_geometry(s, g, tpf, w)
    jk, jv = jnp.asarray(k), jnp.asarray(v)
    tk, tv = _t(k, v)
    for rank in range(ring):
        off = rank * f_loc
        rows = slice(g + off * tpf, g + (off + f_loc) * tpf)
        q_loc, do_loc = q[:, rows], do[:, rows]
        joff = jnp.array([off], jnp.int32)
        o_j, lse_j = j_banded.banded_flash_attention_local(jnp.asarray(q_loc), jk, jv, g, tpf, w, joff, f,
                                                           interpret=True, return_lse=True)
        tq = torch.from_numpy(q_loc)
        shard = geo.shard(off, f_loc)
        o, lse = af.banded_f32_blocked(tq, tk, tv, shard, return_lse=True)
        o_ref, lse_ref = banded_flash_attention_local_reference(tq, tk, tv, g, tpf, w, off, f, return_lse=True)
        what = f"rank {rank} offset {off}"
        _close(o, np.asarray(o_j), what=f"B6 {what} pallas")
        _close(o, o_ref, what=f"B6 {what} plain")
        np.testing.assert_allclose(lse.numpy(), lse_ref.numpy(), atol=LSE_ATOL, err_msg=what)

        want_jax = j_banded_bwd.banded_flash_attention_local_bwd(jnp.asarray(q_loc), jk, jv, o_j, lse_j,
                                                                 jnp.asarray(do_loc), g, tpf, w, joff, f,
                                                                 interpret=True)
        args = _t(q_loc, k, v, o_j, lse_j, do_loc)
        got = af.banded_bwd_f32_blocked(*args, shard)
        want = banded_flash_attention_local_bwd_reference(*args, g, tpf, w, off, f)
        real = shard.real_frames() * tpf
        for name, a, r, rj in zip(("dq", "dk", "dv"), got, want, want_jax):
            rj = np.array(rj)
            if name == "dq":  # JAX leaves a dummy frame's dq to the caller, which drops it; the kernel writes 0
                rj[:, real:] = 0.0
                assert not a[:, real:].any()
            _close(a, rj, bwd=True, what=f"B7 {name} {what} pallas")
            _close(a, r, bwd=True, what=f"B7 {name} {what} plain")


def test_float32_route_reaches_the_fp32_plain_versions():
    """The ``--dtype float32`` route: a tiny fp32 pipeline's ``generate``
    with the exact backend, and its windowed attention, hand every
    attention wrapper fp32 q, k, v (on the card: the fp32 kernels) and get
    fp32 back; nothing on the route is cast down to bf16."""
    from s2v_torch.kernels import banded_attention as ba
    from s2v_torch.kernels import flash_attention as fa
    from s2v_torch.ops.attention import joint_attention
    from s2v_torch.testing import tiny_generate_kwargs, tiny_pipeline

    seen = []

    def record(fn):
        def wrapped(q, k, v, *a, **kw):
            seen.append((fn.__name__, q.dtype, k.dtype, v.dtype))
            out = fn(q, k, v, *a, **kw)
            first = out[0] if isinstance(out, tuple) else out
            seen.append((fn.__name__ + " out", first.dtype))
            return out
        return wrapped

    saved = fa.flash_attention_reference, ba.banded_flash_attention_reference
    fa.flash_attention_reference = record(saved[0])
    ba.banded_flash_attention_reference = record(saved[1])
    casts = []
    to = torch.Tensor.to

    def watched_to(self, *a, **kw):
        if torch.bfloat16 in a or kw.get("dtype") is torch.bfloat16:
            casts.append(tuple(self.shape))
        return to(self, *a, **kw)

    torch.Tensor.to = watched_to
    try:
        pipe = tiny_pipeline("flash", device="cpu", attention_head_dim=64, num_attention_heads=2)
        assert pipe.transformer_cfg.dtype == torch.float32
        latents = pipe.generate(**tiny_generate_kwargs(pipe, output_type="latent"))
        assert latents.dtype == torch.float32
        g, tpf, frames = 24, 16, 5
        x = torch.randn(1, g + frames * tpf, 128)
        attn = pipe.transformer_params["blocks"][0]["attn"]
        out = joint_attention(attn, x, 2, backend="windowed", window=(g, tpf, 1))
        assert out.dtype == torch.float32
    finally:
        torch.Tensor.to = to
        fa.flash_attention_reference, ba.banded_flash_attention_reference = saved
    assert {name for name, *_ in seen} >= {"flash_attention_reference", "banded_flash_attention_reference"}
    assert all(dt == torch.float32 for _, *dts in seen for dt in dts), seen
    assert not casts, casts
