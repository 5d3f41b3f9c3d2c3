"""The banded CUDA kernels' schedules, emulated in PyTorch
(``banded_flash_attention_blocked`` for B4/B6: 128-row query tiles inside a
frame, 128-key tiles over the global range and then the window, online
softmax in tile order, P rounded to bf16 for P·V;
``banded_flash_attention_bwd_blocked`` for B5/B7: the dq walk over 64-key
tiles and the dk/dv walk over the inverse band in 64-query tiles, P and dS
rounded to bf16), against the plain versions and the JAX package's Pallas
B4-B7 in interpret mode, on the same numpy inputs in fp32.  The geometries
hit the traps of the band: G and tpf with the main shape's remainders
(1,576 ≡ 40 and 1,350 ≡ 70 mod 128), a frame of three query tiles, touching
key ranges (ws = 0), clamped windows, w = 0, span = F, and B6/B7 at every
offset of a 2- and a 4-rank ring with dummy frames.  The card holds the
kernels to the same emulations (tests/test_torch_gpu.py, chip_smoke.py)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from _torch_parity import band_inputs
from s2v_tpu.ops.pallas import banded_attention as j_fwd
from s2v_tpu.ops.pallas import banded_attention_bwd as j_bwd
from s2v_torch.kernels.banded_attention import (
    KERNEL_KEY_TILE,
    band_geometry,
    band_mask,
    banded_flash_attention_blocked,
    banded_flash_attention_local_reference,
    banded_flash_attention_reference,
    ring_shards,
)
from s2v_torch.kernels.banded_attention_bwd import (
    banded_flash_attention_bwd_blocked,
    banded_flash_attention_bwd_reference,
    banded_flash_attention_local_bwd_reference,
)

# fp32 inputs; the emulations round P (and dS) to bf16 (relative 2^-9 each,
# 2^-8 after the product), so they are held to the card's limits for a kernel
# against its plain version: max error at most 2^-6 of the largest element,
# relative L2 below 1e-2.  A dropped, repeated or unmasked key tile moves the
# relative L2 by several percent.  lse is fp32 in both and the emulation
# does not round it: 1e-4.
MAX_REL, L2_REL = 2.0 ** -6, 1e-2
LSE_ATOL = 1e-4

# (B, H, G, tpf, F, w)
GEOMETRIES = {
    "main_remainders": (1, 2, 168, 198, 5, 2),
    "three_query_tiles": (1, 1, 40, 300, 3, 1),
    "w0": (1, 2, 24, 20, 4, 0),
    "clamped_batch2": (2, 2, 24, 20, 5, 1),
    "span_equals_F": (1, 2, 50, 40, 5, 9),
}
# B6/B7: every offset of these rings; F = 5 pads to 6 (one dummy frame) and 8 (three)
LOCAL = [("main_remainders", 2), ("main_remainders", 4), ("clamped_batch2", 4)]


def _assert_close(got, want, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    diff = got - want
    assert np.abs(diff).max() <= MAX_REL * np.abs(want).max(), what
    assert np.linalg.norm(diff) / np.linalg.norm(want) < L2_REL, what


def _torch(*xs):
    return [torch.from_numpy(np.array(x)) for x in xs]


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_blocked_forward_matches_plain_and_pallas(geometry):
    b, h, g, tpf, f, w = GEOMETRIES[geometry]
    q, k, v = band_inputs(b, h, g, tpf, f, seed=f * tpf + g, d=64, n=3)
    o_j, lse_j = j_fwd.banded_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), g, tpf, w,
                                              interpret=True, return_lse=True)
    tq, tk, tv = _torch(q, k, v)
    o, lse = banded_flash_attention_blocked(tq, tk, tv, g, tpf, w, return_lse=True)
    o_ref, lse_ref = banded_flash_attention_reference(tq, tk, tv, g, tpf, w, return_lse=True)
    assert o.shape == tq.shape and lse.shape == (b, h, tq.shape[1])
    _assert_close(o.numpy(), o_ref.numpy())
    _assert_close(o.numpy(), np.asarray(o_j))
    np.testing.assert_allclose(lse.numpy(), lse_ref.numpy(), atol=LSE_ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j), atol=LSE_ATOL)


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_blocked_backward_matches_plain_and_pallas(geometry):
    b, h, g, tpf, f, w = GEOMETRIES[geometry]
    q, k, v, do = band_inputs(b, h, g, tpf, f, seed=f * tpf + g + 1, d=64)
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    o, lse = j_fwd.banded_flash_attention(jq, jk, jv, g, tpf, w, interpret=True, return_lse=True)
    want_jax = j_bwd.banded_flash_attention_bwd(jq, jk, jv, o, lse, jnp.asarray(do), g, tpf, w, interpret=True)
    args = _torch(q, k, v, o, lse, do)
    got = banded_flash_attention_bwd_blocked(*args, g, tpf, w)
    want = banded_flash_attention_bwd_reference(*args, g, tpf, w)
    for name, a, r, rj, x in zip(("dq", "dk", "dv"), got, want, want_jax, (q, k, v)):
        assert a.shape == x.shape and a.dtype == torch.float32
        _assert_close(a.numpy(), r.numpy(), name)
        _assert_close(a.numpy(), np.asarray(rj), name)


def _ring_inputs(geometry, ring, seed):
    """q, k, v, dO with the video rows padded to the ring: dummy frames' q
    rows random, their dO rows zero, as the SP wrapper pads them."""
    b, h, g, tpf, f, w = GEOMETRIES[geometry]
    f_pad, f_loc = ring_shards(f, ring)
    q, k, v, do = band_inputs(b, h, g, tpf, f_pad, seed=seed, d=64)
    s = g + f * tpf
    do[:, s:] = 0.0
    return (g, tpf, f, w), q, k[:, :s], v[:, :s], do, f_loc


@pytest.mark.parametrize("geometry,ring", LOCAL, ids=[f"{g}-ring{r}" for g, r in LOCAL])
def test_blocked_local_matches_plain_and_pallas_at_every_offset(geometry, ring):
    (g, tpf, f, w), q, k, v, do, f_loc = _ring_inputs(geometry, ring, seed=ring * 7)
    jk, jv = jnp.asarray(k), jnp.asarray(v)
    tk, tv = _torch(k, v)
    for rank in range(ring):
        off = rank * f_loc
        rows = slice(g + off * tpf, g + (off + f_loc) * tpf)
        q_loc, do_loc = q[:, rows], do[:, rows]
        joff = jnp.array([off], jnp.int32)
        o_j, lse_j = j_fwd.banded_flash_attention_local(jnp.asarray(q_loc), jk, jv, g, tpf, w, joff, f,
                                                        interpret=True, return_lse=True)
        want_jax = j_bwd.banded_flash_attention_local_bwd(jnp.asarray(q_loc), jk, jv, o_j, lse_j,
                                                          jnp.asarray(do_loc), g, tpf, w, joff, f, interpret=True)
        tq = torch.from_numpy(q_loc)
        o, lse = banded_flash_attention_blocked(tq, tk, tv, g, tpf, w, return_lse=True, frame_offset=off,
                                                n_frames_total=f)
        o_ref, lse_ref = banded_flash_attention_local_reference(tq, tk, tv, g, tpf, w, off, f, return_lse=True)
        what = f"rank {rank} offset {off}"
        assert o.shape == tq.shape and lse.shape == lse_ref.shape
        _assert_close(o.numpy(), o_ref.numpy(), what)
        _assert_close(o.numpy(), np.asarray(o_j), what)
        np.testing.assert_allclose(lse.numpy(), lse_ref.numpy(), atol=LSE_ATOL, err_msg=what)
        np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j), atol=LSE_ATOL, err_msg=what)

        args = _torch(q_loc, k, v, o_j, lse_j, do_loc)
        got = banded_flash_attention_bwd_blocked(*args, g, tpf, w, frame_offset=off, n_frames_total=f)
        want = banded_flash_attention_local_bwd_reference(*args, g, tpf, w, off, f)
        for name, a, r, rj in zip(("dq", "dk", "dv"), got, want, want_jax):
            assert a.shape == r.shape
            if not r.any():  # a partial that no query of the shard's band reaches
                assert not a.any() and not np.asarray(rj).any(), f"{what} {name}"
                continue
            _assert_close(a.numpy(), r.numpy(), f"{what} {name}")
            _assert_close(a.numpy(), np.asarray(rj), f"{what} {name}")


def test_blocked_local_ignores_dummy_frames():
    """Junk in a dummy frame's q, dO and lse rows (the last rank of a 4-rank
    ring over 5 frames holds 1 real frame and 1 dummy) changes no real
    gradient, bit for bit, and its dq rows are zero: the kernels' dummy-frame
    gate on the card."""
    (g, tpf, f, w), q, k, v, do, f_loc = _ring_inputs("clamped_batch2", 4, seed=3)
    off = 3 * f_loc
    real = (f - off) * tpf
    q_loc, do_loc = (torch.from_numpy(x[:, g + off * tpf:g + (off + f_loc) * tpf]) for x in (q, do))
    tk, tv = _torch(k, v)
    o, lse = banded_flash_attention_blocked(q_loc, tk, tv, g, tpf, w, return_lse=True, frame_offset=off,
                                            n_frames_total=f)
    clean = banded_flash_attention_bwd_blocked(q_loc, tk, tv, o, lse, do_loc, g, tpf, w, frame_offset=off,
                                               n_frames_total=f)
    junk = torch.from_numpy(np.random.RandomState(9).randn(*q_loc.shape).astype(np.float32)) * 100
    dirty_args = [x.clone() for x in (q_loc, o, do_loc)]
    for x in dirty_args:
        x[:, real:] = junk[:, real:]
    lse_dirty = lse.clone()
    lse_dirty[..., real:] = -1e30
    q_d, o_d, do_d = dirty_args
    dirty = banded_flash_attention_bwd_blocked(q_d, tk, tv, o_d, lse_dirty, do_d, g, tpf, w, frame_offset=off,
                                               n_frames_total=f)
    assert torch.equal(clean[0][:, :real], dirty[0][:, :real]) and not dirty[0][:, real:].any()
    assert torch.equal(clean[1], dirty[1]) and torch.equal(clean[2], dirty[2])


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_key_tiles_walk_the_band_once_in_order(geometry):
    """Each query frame's key tiles (dummy frames included) cover exactly the
    keys the band mask gives it, each once, in increasing order within a
    range; a tile's range ends inside it only at the last tile of a range;
    the two ranges are walked as one exactly when ws = 0."""
    _, _, g, tpf, f, w = GEOMETRIES[geometry]
    s = g + f * tpf
    geo = band_geometry(s, g, tpf, w)
    for frame in range(f + 2):  # two dummy frames past the clip take the last window
        tiles = geo.key_tiles(frame, KERNEL_KEY_TILE)
        keys = torch.cat([torch.arange(kb, min(kb + KERNEL_KEY_TILE, kend)) for kb, kend in tiles])
        row = g + min(frame, f - 1) * tpf  # a dummy frame's window is the last frame's
        want = torch.nonzero(band_mask(geo, torch.tensor([row]), s)[0])[:, 0]
        assert torch.equal(keys, want), frame
        ends = [kend for _, kend in tiles]
        ragged = [i for i, (kb, kend) in enumerate(tiles) if kb + KERNEL_KEY_TILE > kend]
        assert all(i == len(tiles) - 1 or ends[i + 1] != ends[i] for i in ragged), frame
        assert (len(set(ends)) == 1) == (geo.window_start(frame) == 0), frame
