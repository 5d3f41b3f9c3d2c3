"""Kernels B6 and B7, one sequence-parallel shard of video-query frames: their
plain PyTorch versions (what the port runs on CPU tensors) against the JAX
package's ``banded_flash_attention_local`` and ``banded_flash_attention_local_bwd``
with the Pallas kernels in interpret mode, at every shard offset of a 4-rank
ring; B6 stitched over the shards against B4; dummy frames; the shard
geometry; and the CUDA branch's input checks on meta tensors.  The same numpy
inputs go into both packages, in fp32."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from _torch_parity import band_inputs
from s2v_tpu.ops.pallas.banded_attention import banded_flash_attention_local as j_local
from s2v_tpu.ops.pallas.banded_attention_bwd import banded_flash_attention_local_bwd as j_local_bwd
from s2v_torch.kernels.banded_attention import (
    band_geometry,
    banded_flash_attention,
    banded_flash_attention_local,
    banded_flash_attention_local_reference,
    check_banded_kernel_inputs,
    local_geometry,
    ring_shards,
)
from s2v_torch.kernels.banded_attention_bwd import (
    banded_flash_attention_local_bwd,
    check_banded_local_bwd_kernel_inputs,
)

# the JAX package's own SP tests' tolerances (tests/test_parallel.py:540-690):
# fp32 both sides, sums in another order and the scale applied before the
# product there, after it here
FWD_ATOL, FWD_RTOL = 2e-5, 1e-4
BWD_ATOL, BWD_RTOL = 2e-4, 1e-3
G, TPF, W, RING = 5, 4, 1, 4


def _shards(n_frames, seed):
    """q, k, v, dO over the ring-padded clip (dummy frames' q rows random,
    their dO rows zero, as the SP wrapper pads them) and the shard size."""
    f_pad, f_loc = ring_shards(n_frames, RING)
    q, k, v, do = band_inputs(1, 2, G, TPF, f_pad, seed=seed, d=8)
    s = G + n_frames * TPF
    do[:, s:] = 0.0
    return q, k[:, :s], v[:, :s], do, f_loc


@pytest.mark.parametrize("n_frames", [8, 6], ids=["F8", "F6_dummy"])
def test_local_forward_matches_jax_at_every_offset(n_frames):
    q, k, v, _, f_loc = _shards(n_frames, seed=n_frames)
    tk, tv = torch.from_numpy(k), torch.from_numpy(v)
    outs = []
    for rank in range(RING):
        off = rank * f_loc
        q_loc = q[:, G + off * TPF:G + (off + f_loc) * TPF]
        o_j, lse_j = j_local(jnp.asarray(q_loc), jnp.asarray(k), jnp.asarray(v), G, TPF, W,
                             jnp.array([off], jnp.int32), n_frames, interpret=True, return_lse=True)
        o, lse = banded_flash_attention_local(torch.from_numpy(q_loc), tk, tv, G, TPF, W, off, n_frames,
                                              return_lse=True)
        assert o.shape == q_loc.shape and lse.shape == (1, 2, f_loc * TPF)
        np.testing.assert_allclose(o.numpy(), np.asarray(o_j), atol=FWD_ATOL, rtol=FWD_RTOL, err_msg=f"rank {rank}")
        np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j), atol=FWD_ATOL, rtol=FWD_RTOL,
                                   err_msg=f"rank {rank}")
        outs.append(o)
    # the shards' real rows stitched together are B4's video rows
    s = G + n_frames * TPF
    want = banded_flash_attention(torch.from_numpy(q[:, :s]), tk, tv, G, TPF, W)
    got = torch.cat(outs, dim=1)[:, :n_frames * TPF]
    np.testing.assert_allclose(got.numpy(), want[:, G:].numpy(), atol=FWD_ATOL, rtol=FWD_RTOL)


@pytest.mark.parametrize("n_frames", [8, 6], ids=["F8", "F6_dummy"])
def test_local_backward_matches_jax_at_every_offset(n_frames):
    q, k, v, do, f_loc = _shards(n_frames, seed=10 + n_frames)
    tk, tv = torch.from_numpy(k), torch.from_numpy(v)
    for rank in range(RING):
        off = rank * f_loc
        rows = slice(G + off * TPF, G + (off + f_loc) * TPF)
        q_loc, do_loc = q[:, rows], do[:, rows]
        o_j, lse_j = j_local(jnp.asarray(q_loc), jnp.asarray(k), jnp.asarray(v), G, TPF, W,
                             jnp.array([off], jnp.int32), n_frames, interpret=True, return_lse=True)
        want = j_local_bwd(jnp.asarray(q_loc), jnp.asarray(k), jnp.asarray(v), o_j, lse_j, jnp.asarray(do_loc),
                           G, TPF, W, jnp.array([off], jnp.int32), n_frames, interpret=True)
        o, lse = torch.from_numpy(np.asarray(o_j)), torch.from_numpy(np.asarray(lse_j))
        got = banded_flash_attention_local_bwd(torch.from_numpy(q_loc), tk, tv, o, lse, torch.from_numpy(do_loc),
                                               G, TPF, W, off, n_frames)
        assert got[0].shape == q_loc.shape and got[1].shape == got[2].shape == k.shape
        for name, a, b in zip(("dq", "dk", "dv"), got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=BWD_ATOL, rtol=BWD_RTOL,
                                       err_msg=f"rank {rank} {name}")


def test_dummy_frames_contribute_nothing():
    """Whatever a dummy frame's q and dO hold, its dq rows are zero and the
    partial dk/dv do not change (the port bounds its walks by F)."""
    n_frames = 6
    q, k, v, do, f_loc = _shards(n_frames, seed=21)
    tk, tv = torch.from_numpy(k), torch.from_numpy(v)
    for off in (2 * f_loc, 3 * f_loc):  # frames 4, 5 real; frames 6, 7 both dummy
        q_loc = torch.from_numpy(q[:, G + off * TPF:G + (off + f_loc) * TPF])
        o, lse = banded_flash_attention_local(q_loc, tk, tv, G, TPF, W, off, n_frames, return_lse=True)
        real = max(0, n_frames - off) * TPF
        do_zero = torch.randn(q_loc.shape, generator=torch.Generator().manual_seed(off))
        do_zero[:, real:] = 0
        do_junk = do_zero.clone()
        do_junk[:, real:] = 7.0
        a = banded_flash_attention_local_bwd(q_loc, tk, tv, o, lse, do_zero, G, TPF, W, off, n_frames)
        b = banded_flash_attention_local_bwd(q_loc, tk, tv, o, lse, do_junk, G, TPF, W, off, n_frames)
        assert torch.equal(a[0][:, :real], b[0][:, :real]) and not b[0][:, real:].any()
        assert torch.equal(a[1], b[1]) and torch.equal(a[2], b[2])
        if real == 0:
            assert not (a[1].any() or a[2].any())


def test_world_size_one_is_the_banded_kernel():
    """One shard at offset 0 holding every frame is B4's video rows, lse included."""
    q, k, v = (torch.from_numpy(x) for x in band_inputs(2, 3, 24, 20, 5, seed=3, n=3))
    o, lse = banded_flash_attention_local(q[:, 24:], k, v, 24, 20, 1, 0, 5, return_lse=True)
    want, want_lse = banded_flash_attention(q, k, v, 24, 20, 1, return_lse=True)
    assert torch.allclose(o, want[:, 24:], atol=1e-6) and torch.allclose(lse, want_lse[..., 24:], atol=1e-6)


def test_reference_chunks_agree():
    """The plain version's query chunks (512 rows) stitch to one softmax:
    a shard longer than a chunk against the shard's rows of B4."""
    q, k, v = (torch.from_numpy(x) for x in band_inputs(1, 1, 40, 130, 6, seed=4, n=3))
    got = banded_flash_attention_local_reference(q[:, 40 + 2 * 130:40 + 6 * 130], k, v, 40, 130, 1, 2, 6)
    want = banded_flash_attention(q, k, v, 40, 130, 1)[:, 40 + 2 * 130:]
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("f,ring", [(13, 1), (13, 2), (13, 4), (6, 4), (5, 4), (8, 3), (1, 1)])
def test_ring_shards_cover_the_clip(f, ring):
    f_pad, f_loc = ring_shards(f, ring)
    assert f_pad == ring * f_loc and f <= f_pad < f + ring
    geo = band_geometry(3 + f * 2, 3, 2, 1)
    shards = [geo.shard(r * f_loc, f_loc) for r in range(ring)]
    assert sum(s.real_frames() for s in shards) == f
    assert sum(s.shard_pairs() for s in shards) == geo.pairs()[0]


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(*shape, dtype=dtype, device="meta")


def test_shard_and_kernel_input_checks():
    """The host checks run before any launch; meta tensors stand in for the card's."""
    g, tpf, f = 24, 20, 5
    k = _meta(2, g + f * tpf, 3, 64)
    q = _meta(2, 2 * tpf, 3, 64)
    for off in (0, 3, 8):  # 8 + 2 frames = F·F_loc: the last offset of the widest ring
        geo = local_geometry(q, k, k, g, tpf, 1, torch.tensor([off], dtype=torch.int32), f)
        assert (geo.frame_offset, geo.local_frames, geo.n_frames) == (off, 2, f)
    for bad_off in (-1, 9):
        with pytest.raises(ValueError, match="ring-padded clip"):
            banded_flash_attention_local(q, k, k, g, tpf, 1, bad_off, f)
    with pytest.raises(ValueError, match="1 to F"):
        banded_flash_attention_local(_meta(2, 6 * tpf, 3, 64), k, k, g, tpf, 1, 0, f)
    with pytest.raises(ValueError, match="ragged local"):
        banded_flash_attention_local(_meta(2, 2 * tpf + 1, 3, 64), k, k, g, tpf, 1, 0, f)
    with pytest.raises(ValueError, match="full sequence"):
        banded_flash_attention_local(q, k, k, g, tpf, 1, 0, f + 1)
    with pytest.raises(ValueError):
        banded_flash_attention_local(q, k[:, 1:], k[:, 1:], g, tpf, 1, 0, f)
    with pytest.raises(ValueError):  # heads differ
        banded_flash_attention_local(_meta(2, 2 * tpf, 2, 64), k, k, g, tpf, 1, 0, f)
    # Sq != S is the shard's normal case; the kernel checks are B4's per tensor
    check_banded_kernel_inputs(k, k, k)
    lse = torch.empty(2, 3, 2 * tpf, device="meta")
    check_banded_local_bwd_kernel_inputs(q, k, k, q, lse, q)
    for bad in (dict(q=_meta(2, 2 * tpf, 3, 64, dtype=torch.float32)), dict(k=_meta(2, g + f * tpf, 3, 32)),
                dict(lse=lse.to(torch.bfloat16)), dict(o=_meta(2, 2 * tpf, 3, 128)[..., ::2])):
        args = dict(q=q, k=k, o=q, lse=lse)
        args.update(bad)
        with pytest.raises(ValueError):
            check_banded_local_bwd_kernel_inputs(args["q"], args["k"], args["k"], args["o"], args["lse"], q)
    with pytest.raises(ValueError, match="lse must be"):
        banded_flash_attention_local_bwd(q, k, k, q, torch.empty(2, 3, 7, device="meta"), q, g, tpf, 1, 0, f)
