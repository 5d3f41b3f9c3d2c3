"""Kernels B1-B7 on the card against their plain PyTorch versions (B2,
B3 and B4-B7 also against the emulations of their schedules, and B2, B3, B5
and B7 twice for determinism; B3's pre-pass kernels bit for bit against the
plain pre-pass, and one s8 wgmma tile of its 64-byte-swizzle layer against
an integer matmul; B6/B7,
the sequence-parallel shard kernels, at every offset of 2- and 4-rank
rings), the differentiable flash and banded attentions (B1/B2, B4/B5, and
``sp_windowed`` on a one-rank NCCL group) against plain autograd, and the
int8 linears (``torch._int_mm``) against their CPU computation.

Marked ``gpu``; every test skips without a CUDA device (decided inside the
fixture, so every worker collects the same tests).  On a machine with a card:

    python -m pytest tests/test_torch_gpu.py --noconftest -m gpu -q

(``--noconftest``: the repo's conftest configures JAX, which that machine
does not have; this file imports only torch.)
"""

import numpy as np
import pytest
import torch

from s2v_torch.kernels.banded_attention import (
    band_geometry,
    banded_flash_attention,
    banded_flash_attention_blocked,
    banded_flash_attention_local,
    banded_flash_attention_local_reference,
    banded_flash_attention_reference,
    ring_shards,
)
from s2v_torch.kernels.banded_attention_bwd import (
    banded_flash_attention_bwd,
    banded_flash_attention_bwd_blocked,
    banded_flash_attention_bwd_reference,
    banded_flash_attention_local_bwd,
    banded_flash_attention_local_bwd_reference,
)
from s2v_torch.kernels.flash_attention import (
    flash_attention,
    flash_attention_reference,
)
from s2v_torch.kernels.flash_attention_bwd import (
    flash_attention_bwd,
    flash_attention_bwd_blocked,
    flash_attention_bwd_reference,
)
from s2v_torch.kernels.int8_attention import (
    flash_attention_qk_int8,
    flash_attention_qk_int8_blocked,
    flash_attention_qk_int8_reference,
    int8_prepass,
    int8_qk_tile,
    launch_int8_prepass,
)
from s2v_torch.ops.attention import banded_attention_trainable, flash_attention_trainable
from s2v_torch.ops.windowed_attention import windowed_attention_reference

pytestmark = pytest.mark.gpu

# bf16 inputs, fp32 plain version on the same bf16 values: the kernel rounds
# P to bf16 before P·V and writes a bf16 output (relative 2^-8).  With N(0,1)
# logits over at most 333 keys the outputs here are of order 0.1 to 1, where
# 2e-2 is a few bf16 ulps of the largest; the relative L2 bound catches an
# error spread over many elements (a dropped K/V tile) that stays under it.
ATOL = 2e-2
L2_REL = 1e-2


def _assert_close(o, o_ref):
    diff = o.float() - o_ref.float()
    assert diff.abs().max().item() < ATOL
    assert (diff.norm() / o_ref.float().norm()).item() < L2_REL


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _qkv(b, sq, skv, h, seed, device):
    rng = np.random.RandomState(seed)
    q, k, v = (torch.from_numpy(rng.randn(b, s, h, 64).astype(np.float32)).to(device, torch.bfloat16)
               for s in (sq, skv, skv))
    return q, k, v


@pytest.mark.parametrize("mode", ["online", "bounded", "bounded_exp2"])
@pytest.mark.parametrize("sq,skv,masked", [(200, 200, False), (77, 333, True), (1000, 129, False)])
def test_kernel_matches_plain(cuda, mode, sq, skv, masked):
    q, k, v = _qkv(2, sq, skv, 3, 0, cuda)
    mask = None
    if masked:
        mask = torch.zeros(skv, dtype=torch.bool, device=cuda)
        mask[5:40] = True
        mask[-3:] = True
    o, lse = flash_attention(q, k, v, return_lse=True, key_pad_mask=mask, softmax_mode=mode)
    o_ref, lse_ref = flash_attention_reference(q, k, v, return_lse=True, key_pad_mask=mask, softmax_mode=mode)
    torch.cuda.synchronize()
    assert o.shape == q.shape and lse.shape == (2, 3, sq)
    _assert_close(o, o_ref)
    assert (lse - lse_ref).abs().max().item() < 1e-2


def test_bounded_reruns_online_on_underflow(cuda):
    q, k, v = _qkv(1, 256, 256, 2, 1, cuda)
    q[:, :, :, 32:] = 0
    k[:, :, :, :32] = 0
    q *= 40
    k *= 40
    before = flash_attention.reruns
    o = flash_attention(q, k, v, softmax_mode="bounded")
    assert flash_attention.reruns == before + 1
    o_ref = flash_attention_reference(q, k, v, softmax_mode="online")
    _assert_close(o, o_ref)


def test_fully_masked_rows_are_zero(cuda):
    q, k, v = _qkv(1, 64, 64, 1, 2, cuda)
    mask = torch.ones(64, dtype=torch.bool, device=cuda)
    o, lse = flash_attention(q, k, v, return_lse=True, key_pad_mask=mask, softmax_mode="online")
    assert o.float().abs().max().item() == 0.0
    assert lse.max().item() == np.float32(-1e30)


def test_unsupported_inputs_raise_before_launch(cuda):
    q, k, v = _qkv(1, 64, 64, 1, 3, cuda)
    before = flash_attention.launches
    with pytest.raises(ValueError):
        flash_attention(q.float(), k.float(), v.float())
    with pytest.raises(ValueError):
        flash_attention(q[..., :32], k[..., :32], v[..., :32])
    # a view whose base pointer is 2 bytes off a 16-byte boundary
    shifted = torch.empty(q.numel() + 1, dtype=q.dtype, device=cuda)[1:].view(q.shape)
    with pytest.raises(ValueError):
        flash_attention(shifted, k, v)
    assert flash_attention.launches == before


# B2 against its plain version on the same bf16 inputs: the kernel rounds P
# and dS to bf16 before their products and writes bf16 grads (relative 2^-8
# each); gradients here are of order 0.1 to 2, so the bars above hold them
# to a few bf16 ulps of the largest and to 1% in relative L2.
@pytest.mark.parametrize("sq,skv", [(200, 200), (77, 333), (1000, 129)])
def test_bwd_kernel_matches_plain(cuda, sq, skv):
    q, k, v = _qkv(2, sq, skv, 3, 4, cuda)
    o, lse = flash_attention(q, k, v, return_lse=True, softmax_mode="bounded")
    do = torch.from_numpy(np.random.RandomState(5).randn(*q.shape).astype(np.float32)).to(cuda, torch.bfloat16)
    before = flash_attention_bwd.launches
    got = flash_attention_bwd(q, k, v, o, lse, do)
    want = flash_attention_bwd_reference(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    assert flash_attention_bwd.launches == before + 1
    for a, w, x in zip(got, want, (q, k, v)):
        assert a.shape == x.shape and a.dtype == torch.bfloat16
        _assert_close(a, w)


def test_bwd_kernel_reads_strided_views(cuda):
    """q/k/v as views into a fused [B, S, 3, H, d] tensor (the DiT's layout
    after the qkv linear) give the grads of contiguous copies."""
    qkv = torch.from_numpy(np.random.RandomState(6).randn(1, 150, 3, 2, 64).astype(np.float32)).to(cuda, torch.bfloat16)
    q, k, v = qkv.unbind(2)
    o, lse = flash_attention(q, k, v, return_lse=True)
    do = torch.ones_like(q)
    strided = flash_attention_bwd(q, k, v, o, lse, do)
    dense = flash_attention_bwd(q.contiguous(), k.contiguous(), v.contiguous(), o, lse, do)
    for a, b in zip(strided, dense):
        assert torch.equal(a, b)


def test_trainable_grads_match_plain_autograd(cuda):
    q, k, v = (x.requires_grad_() for x in _qkv(1, 300, 300, 2, 7, cuda))
    do = torch.from_numpy(np.random.RandomState(8).randn(1, 300, 2, 64).astype(np.float32)).to(cuda, torch.bfloat16)
    before = (flash_attention.launches, flash_attention_bwd.launches)
    got = torch.autograd.grad(flash_attention_trainable(q, k, v), (q, k, v), do)
    assert (flash_attention.launches, flash_attention_bwd.launches) == (before[0] + 1, before[1] + 1)
    leaves = [x.detach().float().requires_grad_() for x in (q, k, v)]
    s = torch.einsum("bqhd,bkhd->bhqk", leaves[0], leaves[1]) / 8.0
    want = torch.autograd.grad(torch.einsum("bhqk,bkhd->bqhd", s.softmax(-1), leaves[2]), leaves, do.float())
    torch.cuda.synchronize()
    for a, w in zip(got, want):
        _assert_close(a, w)


def test_bwd_unsupported_inputs_raise_before_launch(cuda):
    q, k, v = _qkv(1, 64, 64, 1, 9, cuda)
    o, lse = flash_attention(q, k, v, return_lse=True)
    before = flash_attention_bwd.launches
    with pytest.raises(ValueError):
        flash_attention_bwd(q.float(), k.float(), v.float(), o.float(), lse, o.float())
    with pytest.raises(ValueError):
        flash_attention_bwd(q, k, v, o, lse.to(torch.bfloat16), o)
    shifted = torch.empty(q.numel() + 1, dtype=q.dtype, device=cuda)[1:].view(q.shape)
    with pytest.raises(ValueError):
        flash_attention_bwd(q, k, v, o, lse, shifted)
    assert flash_attention_bwd.launches == before


# B1 and B2 as Hopper kernels (TMA tiles behind mbarrier rings, wgmma):
# lengths that are not whole tiles (B1: 128 queries a block, 128-key tiles;
# B2: 128 resident rows a block, 64-row streamed tiles), fewer keys than one
# tile, a masked key run across a tile boundary, and the strided views of a
# fused qkv tensor; held to the bars above.
RAGGED_FWD = [(129, 127), (64, 1), (250, 385), (1, 300)]
RAGGED_BWD = [(129, 127), (65, 20), (250, 385), (1, 300)]


@pytest.mark.parametrize("mode", ["online", "bounded", "bounded_exp2"])
@pytest.mark.parametrize("sq,skv", RAGGED_FWD)
def test_kernel_ragged_tiles_match_plain(cuda, mode, sq, skv):
    q, k, v = _qkv(1, sq, skv, 2, 3 * sq + skv, cuda)
    o, lse = flash_attention(q, k, v, return_lse=True, softmax_mode=mode)
    o_ref, lse_ref = flash_attention_reference(q, k, v, return_lse=True, softmax_mode=mode)
    torch.cuda.synchronize()
    _assert_close(o, o_ref)
    assert (lse - lse_ref).abs().max().item() < 1e-2


@pytest.mark.parametrize("mode", ["online", "bounded", "bounded_exp2"])
def test_kernel_masked_run_on_strided_views(cuda, mode):
    qkv = torch.from_numpy(np.random.RandomState(12).randn(2, 333, 3, 2, 64).astype(np.float32)).to(cuda, torch.bfloat16)
    q, k, v = qkv.unbind(2)
    mask = torch.zeros(333, dtype=torch.bool, device=cuda)
    mask[100:260] = True  # across the boundary of the first two 128-key tiles
    mask[-5:] = True
    o, lse = flash_attention(q, k, v, return_lse=True, key_pad_mask=mask, softmax_mode=mode)
    dense = [x.contiguous() for x in (q, k, v)]
    o_dense, lse_dense = flash_attention(*dense, return_lse=True, key_pad_mask=mask, softmax_mode=mode)
    o_ref, lse_ref = flash_attention_reference(*dense, return_lse=True, key_pad_mask=mask, softmax_mode=mode)
    torch.cuda.synchronize()
    assert torch.equal(o, o_dense) and torch.equal(lse, lse_dense)
    _assert_close(o, o_ref)
    assert (lse - lse_ref).abs().max().item() < 1e-2


@pytest.mark.parametrize("sq,skv", RAGGED_BWD)
def test_bwd_kernel_ragged_tiles_match_plain_and_schedule(cuda, sq, skv):
    q, k, v = _qkv(1, sq, skv, 2, 5 * sq + skv, cuda)
    o, lse = flash_attention(q, k, v, return_lse=True, softmax_mode="bounded")
    do = torch.from_numpy(np.random.RandomState(sq).randn(*q.shape).astype(np.float32)).to(cuda, torch.bfloat16)
    got = flash_attention_bwd(q, k, v, o, lse, do)
    want = flash_attention_bwd_reference(q, k, v, o, lse, do)
    emulated = flash_attention_bwd_blocked(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    for a, w, e in zip(got, want, emulated):
        _assert_close(a, w)
        _assert_close(a, e)


def test_bwd_kernel_is_deterministic(cuda):
    """Two launches on the same inputs (strided views of a fused qkv) give
    the same gradients bit for bit: every output has one writer."""
    qkv = torch.from_numpy(np.random.RandomState(13).randn(1, 700, 3, 3, 64).astype(np.float32)).to(cuda, torch.bfloat16)
    q, k, v = qkv.unbind(2)
    o, lse = flash_attention(q, k, v, return_lse=True, softmax_mode="bounded")
    do = torch.from_numpy(np.random.RandomState(14).randn(1, 700, 3, 64).astype(np.float32)).to(cuda, torch.bfloat16)
    first = flash_attention_bwd(q, k, v, o, lse, do)
    second = flash_attention_bwd(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


# B4 and B5 against their plain versions on the same bf16 inputs, held to
# the bars of B1 and B2 above.  (G, tpf, F, w): ragged frames and globals,
# clamped windows, w = 0, a small clip (edge key frames take every query
# frame), a window wider than the clip, frames of more than one query tile,
# the main shape's remainders (G = 168 and tpf = 198 are 40 and 70 mod 128, as
# 1,576 and 1,350 are), a frame of exactly three query tiles.
BANDS = [(24, 20, 5, 1), (24, 20, 4, 0), (24, 20, 4, 1), (300, 24, 4, 1), (7, 130, 3, 2), (50, 40, 5, 9),
         (129, 300, 4, 1), (168, 198, 5, 2), (40, 384, 3, 1)]


def _band_qkv(g, tpf, f, seed, device):
    q, k, v = _qkv(2, g + f * tpf, g + f * tpf, 3, seed, device)
    return q, k, v


@pytest.mark.parametrize("g,tpf,f,w", BANDS)
def test_banded_kernel_matches_plain(cuda, g, tpf, f, w):
    q, k, v = _band_qkv(g, tpf, f, 10, cuda)
    before = banded_flash_attention.launches
    o, lse = banded_flash_attention(q, k, v, g, tpf, w, return_lse=True)
    o_ref, lse_ref = banded_flash_attention_reference(q, k, v, g, tpf, w, return_lse=True)
    torch.cuda.synchronize()
    assert banded_flash_attention.launches == before + 1
    assert o.shape == q.shape and lse.shape == (2, 3, q.shape[1])
    _assert_close(o, o_ref)
    assert (lse - lse_ref).abs().max().item() < 1e-2


@pytest.mark.parametrize("g,tpf,f,w", BANDS)
def test_banded_bwd_kernel_matches_plain(cuda, g, tpf, f, w):
    q, k, v = _band_qkv(g, tpf, f, 11, cuda)
    o, lse = banded_flash_attention(q, k, v, g, tpf, w, return_lse=True)
    do = torch.from_numpy(np.random.RandomState(12).randn(*q.shape).astype(np.float32)).to(cuda, torch.bfloat16)
    before = (banded_flash_attention_bwd.launches, flash_attention_bwd.launches)
    got = banded_flash_attention_bwd(q, k, v, o, lse, do, g, tpf, w)
    want = banded_flash_attention_bwd_reference(q, k, v, o, lse, do, g, tpf, w)
    torch.cuda.synchronize()
    # the video queries' banded kernels and the global queries' B2
    assert (banded_flash_attention_bwd.launches, flash_attention_bwd.launches) == (before[0] + 1, before[1] + 1)
    for a, r, x in zip(got, want, (q, k, v)):
        assert a.shape == x.shape and a.dtype == torch.bfloat16
        _assert_close(a, r)


@pytest.mark.parametrize("g,tpf,f,w", BANDS)
def test_banded_kernels_match_schedule(cuda, g, tpf, f, w):
    """B4 and B5 against the emulations of their schedules (the same tile
    walks, P and dS rounded to bf16 where the kernels round them)."""
    q, k, v = _band_qkv(g, tpf, f, 16, cuda)
    o, lse = banded_flash_attention(q, k, v, g, tpf, w, return_lse=True)
    o_emu, lse_emu = banded_flash_attention_blocked(q, k, v, g, tpf, w, return_lse=True)
    do = torch.from_numpy(np.random.RandomState(17).randn(*q.shape).astype(np.float32)).to(cuda, torch.bfloat16)
    got = banded_flash_attention_bwd(q, k, v, o, lse, do, g, tpf, w)
    emulated = banded_flash_attention_bwd_blocked(q, k, v, o, lse, do, g, tpf, w)
    torch.cuda.synchronize()
    _assert_close(o, o_emu)
    assert (lse - lse_emu).abs().max().item() < 1e-2
    for a, e in zip(got, emulated):
        _assert_close(a, e)


def test_banded_bwd_kernels_are_deterministic(cuda):
    """Two launches of B5, and of B7 on a shard with a dummy frame, on the
    same inputs give the same gradients bit for bit: every output has one
    writer."""
    g, tpf, f, w = 168, 198, 5, 2
    q, k, v = _band_qkv(g, tpf, f, 18, cuda)
    do = torch.from_numpy(np.random.RandomState(19).randn(*q.shape).astype(np.float32)).to(cuda, torch.bfloat16)
    o, lse = banded_flash_attention(q, k, v, g, tpf, w, return_lse=True)
    f_loc = ring_shards(f, 2)[1]
    q_loc, do_loc = _shard(q, g, tpf, f, f_loc, f_loc), _shard(do, g, tpf, f, f_loc, f_loc)
    o_loc, lse_loc = banded_flash_attention_local(q_loc, k, v, g, tpf, w, f_loc, f, return_lse=True)
    for fn, args in ((banded_flash_attention_bwd, (q, k, v, o, lse, do, g, tpf, w)),
                     (banded_flash_attention_local_bwd, (q_loc, k, v, o_loc, lse_loc, do_loc, g, tpf, w, f_loc, f))):
        first, second = fn(*args), fn(*args)
        torch.cuda.synchronize()
        for a, b in zip(first, second):
            assert torch.equal(a, b)


def test_banded_trainable_grads_match_plain_autograd(cuda):
    g, tpf, f, w = 40, 100, 5, 1
    q, k, v = (x.requires_grad_() for x in _band_qkv(g, tpf, f, 13, cuda))
    do = torch.from_numpy(np.random.RandomState(14).randn(*q.shape).astype(np.float32)).to(cuda, torch.bfloat16)
    got = torch.autograd.grad(banded_attention_trainable(q, k, v, g, tpf, w), (q, k, v), do)
    leaves = [x.detach().float().requires_grad_() for x in (q, k, v)]
    want = torch.autograd.grad(windowed_attention_reference(*leaves, g, tpf, w), leaves, do.float())
    torch.cuda.synchronize()
    for a, r in zip(got, want):
        _assert_close(a, r)


def test_banded_unsupported_inputs_raise_before_launch(cuda):
    q, k, v = _band_qkv(24, 20, 5, 15, cuda)
    o, lse = banded_flash_attention(q, k, v, 24, 20, 1, return_lse=True)
    before = (banded_flash_attention.launches, banded_flash_attention_bwd.launches)
    with pytest.raises(ValueError):
        banded_flash_attention(q.float(), k.float(), v.float(), 24, 20, 1)
    with pytest.raises(ValueError):
        banded_flash_attention(q[..., :32], k[..., :32], v[..., :32], 24, 20, 1)
    with pytest.raises(ValueError):
        banded_flash_attention(q, k, v, 24, 21, 1)
    shifted = torch.empty(q.numel() + 1, dtype=q.dtype, device=cuda)[1:].view(q.shape)
    with pytest.raises(ValueError):
        banded_flash_attention(shifted, k, v, 24, 20, 1)
    with pytest.raises(ValueError):
        banded_flash_attention_bwd(q, k, v, o, lse.to(torch.bfloat16), o, 24, 20, 1)
    with pytest.raises(ValueError):
        banded_flash_attention_bwd(q, k, v, o, lse, shifted, 24, 20, 1)
    assert (banded_flash_attention.launches, banded_flash_attention_bwd.launches) == before


# B6 and B7 (one SP shard of video-query frames at a runtime frame offset)
# against their plain versions at every offset of a 2- and a 4-rank ring,
# dummy frames included, held to B4's and B5's bars
def _shard(x, g, tpf, f, f_loc, off):
    """The shard's video rows of x, zero past the clip (the SP wrapper's)."""
    from s2v_torch.parallel.sp_attention import shard_rows

    return shard_rows(x, band_geometry(g + f * tpf, g, tpf, 0).shard(off, f_loc))


def _ring_shards(f):
    for ring in (2, 4):
        if ring <= f:  # more ranks than frames is refused
            f_loc = ring_shards(f, ring)[1]
            for r in range(ring):
                yield f_loc, r * f_loc


@pytest.mark.parametrize("g,tpf,f,w", BANDS)
def test_banded_local_kernel_matches_plain(cuda, g, tpf, f, w):
    q, k, v = _band_qkv(g, tpf, f, 20, cuda)
    for f_loc, off in _ring_shards(f):
        q_loc = _shard(q, g, tpf, f, f_loc, off)
        before = banded_flash_attention_local.launches
        o, lse = banded_flash_attention_local(q_loc, k, v, g, tpf, w, off, f, return_lse=True)
        o_ref, lse_ref = banded_flash_attention_local_reference(q_loc, k, v, g, tpf, w, off, f, return_lse=True)
        torch.cuda.synchronize()
        assert banded_flash_attention_local.launches == before + 1
        assert o.shape == q_loc.shape and lse.shape == (2, 3, q_loc.shape[1])
        _assert_close(o, o_ref)
        assert (lse - lse_ref).abs().max().item() < 1e-2


@pytest.mark.parametrize("g,tpf,f,w", BANDS)
def test_banded_local_bwd_kernel_matches_plain(cuda, g, tpf, f, w):
    q, k, v = _band_qkv(g, tpf, f, 21, cuda)
    do = torch.from_numpy(np.random.RandomState(22).randn(*q.shape).astype(np.float32)).to(cuda, torch.bfloat16)
    for f_loc, off in _ring_shards(f):
        q_loc, do_loc = _shard(q, g, tpf, f, f_loc, off), _shard(do, g, tpf, f, f_loc, off)
        o, lse = banded_flash_attention_local(q_loc, k, v, g, tpf, w, off, f, return_lse=True)
        before = banded_flash_attention_local_bwd.launches
        got = banded_flash_attention_local_bwd(q_loc, k, v, o, lse, do_loc, g, tpf, w, off, f)
        want = banded_flash_attention_local_bwd_reference(q_loc, k, v, o, lse, do_loc, g, tpf, w, off, f)
        torch.cuda.synchronize()
        assert banded_flash_attention_local_bwd.launches == before + 1
        for a, r, x in zip(got, want, (q_loc, k, v)):
            assert a.shape == x.shape and a.dtype == torch.bfloat16
            if r.any():
                _assert_close(a, r)
            else:  # a partial that no query of the shard's band reaches
                assert not a.any()


@pytest.mark.parametrize("g,tpf,f,w", BANDS)
def test_banded_local_kernels_match_schedule(cuda, g, tpf, f, w):
    """B6 and B7 against the emulations of their schedules at every offset
    of a 2- and a 4-rank ring, dummy frames included."""
    q, k, v = _band_qkv(g, tpf, f, 26, cuda)
    do = torch.from_numpy(np.random.RandomState(27).randn(*q.shape).astype(np.float32)).to(cuda, torch.bfloat16)
    for f_loc, off in _ring_shards(f):
        q_loc, do_loc = _shard(q, g, tpf, f, f_loc, off), _shard(do, g, tpf, f, f_loc, off)
        o, lse = banded_flash_attention_local(q_loc, k, v, g, tpf, w, off, f, return_lse=True)
        o_emu, lse_emu = banded_flash_attention_blocked(q_loc, k, v, g, tpf, w, return_lse=True, frame_offset=off,
                                                        n_frames_total=f)
        got = banded_flash_attention_local_bwd(q_loc, k, v, o, lse, do_loc, g, tpf, w, off, f)
        emulated = banded_flash_attention_bwd_blocked(q_loc, k, v, o, lse, do_loc, g, tpf, w, frame_offset=off,
                                                      n_frames_total=f)
        torch.cuda.synchronize()
        _assert_close(o, o_emu)
        assert (lse - lse_emu).abs().max().item() < 1e-2
        for a, e in zip(got, emulated):
            if e.any():
                _assert_close(a, e)
            else:  # a partial that no query of the shard's band reaches
                assert not a.any()


def test_banded_local_shards_stitch_to_b4_and_b5(cuda):
    """The shards of a 4-rank ring (F = 7: one dummy frame): B6's rows
    stitched are B4's video rows bit for bit (one kernel, the same sums);
    B7's dq stitched is B5's video dq, and its dk/dv partials summed with the
    global queries' B2 part are B5's dk/dv within the bars."""
    g, tpf, f, w = 50, 40, 7, 1
    q, k, v = _band_qkv(g, tpf, f, 23, cuda)
    do = torch.from_numpy(np.random.RandomState(24).randn(*q.shape).astype(np.float32)).to(cuda, torch.bfloat16)
    o4, lse4 = banded_flash_attention(q, k, v, g, tpf, w, return_lse=True)
    dq5, dk5, dv5 = banded_flash_attention_bwd(q, k, v, o4, lse4, do, g, tpf, w)
    _, dk, dv = flash_attention_bwd(q[:, :g], k, v, o4[:, :g], lse4[..., :g].contiguous(), do[:, :g])
    dk, dv = dk.float(), dv.float()
    f_loc = ring_shards(f, 4)[1]
    outs, dqs = [], []
    for r in range(4):
        q_loc, do_loc = _shard(q, g, tpf, f, f_loc, r * f_loc), _shard(do, g, tpf, f, f_loc, r * f_loc)
        o, lse = banded_flash_attention_local(q_loc, k, v, g, tpf, w, r * f_loc, f, return_lse=True)
        dq_r, dk_r, dv_r = banded_flash_attention_local_bwd(q_loc, k, v, o, lse, do_loc, g, tpf, w, r * f_loc, f)
        outs.append(o)
        dqs.append(dq_r)
        dk, dv = dk + dk_r.float(), dv + dv_r.float()
    torch.cuda.synchronize()
    assert torch.equal(torch.cat(outs, dim=1)[:, :f * tpf], o4[:, g:])
    assert torch.equal(torch.cat(dqs, dim=1)[:, :f * tpf], dq5[:, g:])
    _assert_close(dk, dk5)
    _assert_close(dv, dv5)


def test_banded_local_unsupported_inputs_raise_before_launch(cuda):
    g, tpf, f = 24, 20, 5
    q, k, v = _band_qkv(g, tpf, f, 25, cuda)
    q_loc = q[:, g:g + 2 * tpf]
    o, lse = banded_flash_attention_local(q_loc, k, v, g, tpf, 1, 0, f, return_lse=True)
    before = (banded_flash_attention_local.launches, banded_flash_attention_local_bwd.launches)
    for bad_off in (-1, 9):
        with pytest.raises(ValueError):
            banded_flash_attention_local(q_loc, k, v, g, tpf, 1, bad_off, f)
        with pytest.raises(ValueError):
            banded_flash_attention_local_bwd(q_loc, k, v, o, lse, o, g, tpf, 1, bad_off, f)
    with pytest.raises(ValueError):
        banded_flash_attention_local(q_loc.float(), k.float(), v.float(), g, tpf, 1, 0, f)
    with pytest.raises(ValueError):
        banded_flash_attention_local(q_loc[..., :32], k[..., :32], v[..., :32], g, tpf, 1, 0, f)
    with pytest.raises(ValueError):
        banded_flash_attention_local(q_loc, k, v, g, tpf, 1, 0, f + 1)
    with pytest.raises(ValueError):
        banded_flash_attention_local_bwd(q_loc, k, v, o, lse.to(torch.bfloat16), o, g, tpf, 1, 0, f)
    assert (banded_flash_attention_local.launches, banded_flash_attention_local_bwd.launches) == before


def test_sp_windowed_on_one_rank_matches_plain_autograd(cuda):
    """``sp_windowed`` on a one-rank NCCL group (a ``HashStore``, no network):
    the output and the grads of its autograd Function (B6/B1 forward,
    B7/B2 backward, the collectives) against plain autograd of the masked
    reference."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from s2v_torch.ops.windowed_attention import windowed_attention_reference as reference
    from s2v_torch.parallel.sp_attention import banded_allgather_attention_trainable

    started = not dist.is_initialized()
    if started:
        dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("seq",))
        g, tpf, f, w = 40, 100, 5, 1
        q, k, v = (x.requires_grad_() for x in _band_qkv(g, tpf, f, 26, cuda))
        do = torch.from_numpy(np.random.RandomState(27).randn(*q.shape).astype(np.float32)).to(cuda, torch.bfloat16)
        before = (banded_flash_attention_local.launches, banded_flash_attention_local_bwd.launches)
        o = banded_allgather_attention_trainable(q, k, v, mesh, "seq", g, tpf, w)
        got = torch.autograd.grad(o, (q, k, v), do)
        leaves = [x.detach().float().requires_grad_() for x in (q, k, v)]
        o_ref = reference(*leaves, g, tpf, w)
        want = torch.autograd.grad(o_ref, leaves, do.float())
        torch.cuda.synchronize()
        assert (banded_flash_attention_local.launches, banded_flash_attention_local_bwd.launches) == (
            before[0] + 1, before[1] + 1)
        _assert_close(o, o_ref)
        for a, r in zip(got, want):
            _assert_close(a, r)
    finally:
        if started:
            dist.destroy_process_group()


# B3 against its plain version on the same bf16 inputs and the same int8
# pre-pass: the logits are integer-exact in both, so what differs is exp2
# and the bf16 rounding of P before P·V and of the output: B1's bars.
@pytest.mark.parametrize("b,sq,skv,h", [(2, 200, 200, 3), (1, 77, 333, 2), (2, 1000, 129, 2), (1, 90, 90, 1)])
def test_int8_kernel_matches_plain(cuda, b, sq, skv, h):
    q, k, v = _qkv(b, sq, skv, h, 16, cuda)
    before = flash_attention_qk_int8.launches
    o = flash_attention_qk_int8(q, k, v)
    o_ref = flash_attention_qk_int8_reference(q, k, v)
    torch.cuda.synchronize()
    assert flash_attention_qk_int8.launches == before + 1
    assert o.shape == q.shape and o.dtype == torch.bfloat16
    _assert_close(o, o_ref)


def test_int8_kernel_negative_logit_rows(cuda):
    """Every real scaled logit is about -128 and the one key tile is
    ragged (90 keys in a tile of 128): a zero-filled pad key taken as logit
    0 would pin the running max and give an all-zero row."""
    rng = np.random.RandomState(17)
    q = torch.full((1, 90, 1, 64), 4.0, device=cuda, dtype=torch.bfloat16)
    k = (-4.0 + 0.01 * torch.from_numpy(rng.randn(1, 90, 1, 64).astype(np.float32))).to(cuda, torch.bfloat16)
    v = torch.from_numpy(rng.randn(1, 90, 1, 64).astype(np.float32)).to(cuda, torch.bfloat16)
    o = flash_attention_qk_int8(q, k, v)
    o_ref = flash_attention_qk_int8_reference(q, k, v)
    torch.cuda.synchronize()
    assert o_ref.float().abs().max().item() > 0.01
    _assert_close(o, o_ref)


def test_int8_unsupported_inputs_raise_before_launch(cuda):
    q, k, v = _qkv(1, 64, 64, 1, 18, cuda)
    before = flash_attention_qk_int8.launches
    with pytest.raises(ValueError):
        flash_attention_qk_int8(q.float(), k.float(), v.float())
    with pytest.raises(ValueError):
        flash_attention_qk_int8(q[..., :32], k[..., :32], v[..., :32])
    shifted = torch.empty(v.numel() + 1, dtype=v.dtype, device=cuda)[1:].view(v.shape)
    with pytest.raises(ValueError):
        flash_attention_qk_int8(q, k, shifted)
    with pytest.raises(ValueError):
        flash_attention_qk_int8(q, k[:, :0], v[:, :0])
    assert flash_attention_qk_int8.launches == before


def test_int8_wgmma_s8_tile_matches_integer_matmul(cuda):
    """One m64n128k32 s8 wgmma pair (d = 64) through B3's int8 TMA maps
    (64-byte swizzle) and descriptors, against an integer matmul: equal."""
    rng = np.random.RandomState(21)
    q = torch.from_numpy(rng.randint(-127, 128, (64, 64)).astype(np.int8))
    k = torch.from_numpy(rng.randint(-127, 128, (128, 64)).astype(np.int8))
    q[0], k[0] = 127, -127
    got = int8_qk_tile(q.to(cuda), k.to(cuda)).cpu().long()
    assert torch.equal(got, q.long() @ k.long().T)


def _tie_values(rng, shape, e):
    """bf16 values (n + 0.5)·2^e with one element at the amax 127·2^e:
    with that amax the int8 scale is 2^e exactly (fp32), so every element
    divides to an exact .5 and rounds half to even."""
    n = rng.randint(-127, 127, shape).astype(np.float32)
    x = (n + 0.5) * 2.0 ** e
    x.reshape(-1)[0] = 127 * 2.0 ** e
    return torch.from_numpy(x).to(torch.bfloat16)


def _prepass_case(name, cuda):
    rng = np.random.RandomState(22)
    if name == "ties":
        # q is scaled by 1/8 first: its amax 127·2^-3 · 8 gives the scale 2^-3
        return _tie_values(rng, (1, 70, 2, 64), 0).to(cuda), _tie_values(rng, (1, 90, 2, 64), -2).to(cuda)
    q, k, _ = _qkv(2, 130, 77, 3, 23, cuda)
    if name == "zero_k":
        k = torch.zeros_like(k)
    elif name == "halves":
        q[1] *= 3.0
        k[1] *= 0.25
    elif name == "strided":
        q, k = (torch.cat([x, x], dim=2)[:, :, ::2] for x in (q, k))
    return q, k


@pytest.mark.parametrize("name", ["random", "ties", "zero_k", "halves", "strided"])
def test_int8_prepass_kernels_equal_plain_prepass(cuda, name):
    """The pre-pass kernels against ``int8_prepass`` on the same tensors,
    bit for bit: half-to-even ties, an all-zero k (scale 1), CFG halves of
    different magnitudes sharing one scale, and strided views."""
    q, k = _prepass_case(name, cuda)
    before = flash_attention_qk_int8.prepass_launches
    got = launch_int8_prepass(q, k, 0.125)
    want = int8_prepass(q, k, 0.125)
    torch.cuda.synchronize()
    assert flash_attention_qk_int8.prepass_launches == before + 1
    assert got[0].is_contiguous() and got[1].is_contiguous()
    for a, w in zip(got, want):
        assert a.dtype == w.dtype and torch.equal(a, w.reshape(a.shape))
    if name == "ties":
        assert {0, 2, -2}.issubset(set(got[1].unique().tolist()))
    if name == "zero_k":
        assert not got[1].any()


# B3 against the emulation of its schedule (128-row query tiles, 128-key
# tiles, exp2 with the ragged tail at -inf, P rounded to bf16): what differs
# is ex2.approx and the summation order, so the plain version's bars hold.
@pytest.mark.parametrize("b,sq,skv,h", [(2, 200, 182, 3), (1, 77, 333, 2), (1, 300, 54, 2), (2, 129, 128, 1)])
def test_int8_kernel_matches_schedule(cuda, b, sq, skv, h):
    q, k, v = _qkv(b, sq, skv, h, 24, cuda)
    o = flash_attention_qk_int8(q, k, v)
    emulated = flash_attention_qk_int8_blocked(q, k, v)
    torch.cuda.synchronize()
    _assert_close(o, emulated)


def test_int8_kernel_is_deterministic(cuda):
    """Every output element has one writer and the pre-pass's maxima do not
    depend on order: two calls agree bit for bit."""
    q, k, v = _qkv(2, 1000, 1000, 2, 25, cuda)
    assert torch.equal(flash_attention_qk_int8(q, k, v), flash_attention_qk_int8(q, k, v))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", [5, 16, 300])
def test_int8_dense_on_cuda_matches_cpu(cuda, dtype, rows):
    """``torch._int_mm`` on the card (rows <= 16 zero-padded) against the
    CPU computation on the same inputs: the int32 products are exact and
    the rescales are the same fp32 operations, so the forward agrees to the
    last bit of fp32 (one bf16 ulp, 2^-7 of the value, in bf16).  The
    backward's bf16 product accumulates and returns fp32 on both devices,
    in another summation order: the same bars."""
    from s2v_torch.ops.quant import int8_dense, quantize_weight_int8

    rng = np.random.RandomState(19)
    x = torch.from_numpy(rng.randn(1, rows, 256).astype(np.float32)).to(dtype)
    w = torch.from_numpy(0.05 * rng.randn(384, 256).astype(np.float32))
    b = torch.from_numpy(0.1 * rng.randn(384).astype(np.float32)).to(dtype)
    g = torch.from_numpy(rng.randn(1, rows, 384).astype(np.float32)).to(dtype)
    outs = []
    for device in ("cpu", cuda):
        wq = {k: t.to(device) for k, t in quantize_weight_int8(w).items()}
        xd = x.to(device).requires_grad_()
        y = int8_dense(xd, wq, b.to(device))
        (dx,) = torch.autograd.grad(y, xd, g.to(device))
        outs.append((y.detach().float().cpu(), dx.float().cpu()))
    torch.cuda.synchronize()
    for name, got, want in zip(("y", "dx"), outs[1], outs[0]):
        bar = (1e-6 if dtype == torch.float32 else 2.0 ** -7) * want.abs() + 1e-6 * want.abs().max()
        excess = ((got - want).abs() - bar).max().item()
        assert excess <= 0, f"{name}: exceeds its bar by {excess}"
