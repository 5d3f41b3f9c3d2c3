"""Kernels B1-B7 on the card against their plain PyTorch versions (B2,
B3 and B4-B7 also against the emulations of their schedules, and B2, B3, B5
and B7 twice for determinism; B3's pre-pass kernels bit for bit against the
plain pre-pass, and one s8 wgmma tile of its 64-byte-swizzle layer against
an integer matmul; B1-B7 in fp16 too, B1 with a q row far above the others,
B1, B2 and B4-B7 in fp32 (the 3xTF32 kernels, TF32 matmuls off in the plain
versions),
B2, B5 and B7 at a small dO; B6/B7,
the sequence-parallel shard kernels, at every offset of 2- and 4-rank
rings), the differentiable flash and banded attentions (B1/B2, B4/B5, and
``sp_windowed`` on a one-rank NCCL group) against plain autograd, the
``chunked`` backend against B1/B2, a small pipeline's segmented ``generate``
against its whole loop, and the int8 linears (``torch._int_mm``) against
their CPU computation.

Marked ``gpu``; every test skips without a CUDA device (decided inside the
fixture, so every worker collects the same tests).  On a machine with a card:

    python -m pytest tests/test_torch_gpu.py --noconftest -m gpu -q

(``--noconftest``: the repo's conftest configures JAX, which that machine
does not have; this file imports only torch.)
"""

import numpy as np
import pytest
import torch

from s2v_torch.kernels import native
from s2v_torch.kernels.banded_attention import (
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
    before = native.launches("flash_attention_rerun")
    o = flash_attention(q, k, v, softmax_mode="bounded")
    assert native.launches("flash_attention_rerun") == before + 1
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
    before = native.launches("flash_attention")
    with pytest.raises(ValueError):
        flash_attention(q.double(), k.double(), v.double())  # fp32 runs its own kernel; fp64 none
    with pytest.raises(ValueError):
        flash_attention(q[..., :32], k[..., :32], v[..., :32])
    # a view whose base pointer is 2 bytes off a 16-byte boundary
    shifted = torch.empty(q.numel() + 1, dtype=q.dtype, device=cuda)[1:].view(q.shape)
    with pytest.raises(ValueError):
        flash_attention(shifted, k, v)
    assert native.launches("flash_attention") == before


# B2 against its plain version on the same bf16 inputs: the kernel rounds P
# and dS to bf16 before their products and writes bf16 grads (relative 2^-8
# each); gradients here are of order 0.1 to 2, so the bars above hold them
# to a few bf16 ulps of the largest and to 1% in relative L2.
@pytest.mark.parametrize("sq,skv", [(200, 200), (77, 333), (1000, 129)])
def test_bwd_kernel_matches_plain(cuda, sq, skv):
    q, k, v = _qkv(2, sq, skv, 3, 4, cuda)
    o, lse = flash_attention(q, k, v, return_lse=True, softmax_mode="bounded")
    do = torch.from_numpy(np.random.RandomState(5).randn(*q.shape).astype(np.float32)).to(cuda, torch.bfloat16)
    before = native.launches("flash_attention_bwd")
    got = flash_attention_bwd(q, k, v, o, lse, do)
    want = flash_attention_bwd_reference(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    assert native.launches("flash_attention_bwd") == before + 1
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
    before = (native.launches("flash_attention"), native.launches("flash_attention_bwd"))
    got = torch.autograd.grad(flash_attention_trainable(q, k, v), (q, k, v), do)
    assert (native.launches("flash_attention"), native.launches("flash_attention_bwd")) == (
        before[0] + 1, before[1] + 1)
    leaves = [x.detach().float().requires_grad_() for x in (q, k, v)]
    s = torch.einsum("bqhd,bkhd->bhqk", leaves[0], leaves[1]) / 8.0
    want = torch.autograd.grad(torch.einsum("bhqk,bkhd->bqhd", s.softmax(-1), leaves[2]), leaves, do.float())
    torch.cuda.synchronize()
    for a, w in zip(got, want):
        _assert_close(a, w)


def test_bwd_unsupported_inputs_raise_before_launch(cuda):
    q, k, v = _qkv(1, 64, 64, 1, 9, cuda)
    o, lse = flash_attention(q, k, v, return_lse=True)
    before = native.launches("flash_attention_bwd")
    with pytest.raises(ValueError):
        flash_attention_bwd(q.double(), k.double(), v.double(), o.double(), lse, o.double())
    with pytest.raises(ValueError):
        flash_attention_bwd(q, k, v, o, lse.to(torch.bfloat16), o)
    shifted = torch.empty(q.numel() + 1, dtype=q.dtype, device=cuda)[1:].view(q.shape)
    with pytest.raises(ValueError):
        flash_attention_bwd(q, k, v, o, lse, shifted)
    assert native.launches("flash_attention_bwd") == before


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
    before = native.launches("banded_flash_attention")
    o, lse = banded_flash_attention(q, k, v, g, tpf, w, return_lse=True)
    o_ref, lse_ref = banded_flash_attention_reference(q, k, v, g, tpf, w, return_lse=True)
    torch.cuda.synchronize()
    assert native.launches("banded_flash_attention") == before + 1
    assert o.shape == q.shape and lse.shape == (2, 3, q.shape[1])
    _assert_close(o, o_ref)
    assert (lse - lse_ref).abs().max().item() < 1e-2


@pytest.mark.parametrize("g,tpf,f,w", BANDS)
def test_banded_bwd_kernel_matches_plain(cuda, g, tpf, f, w):
    q, k, v = _band_qkv(g, tpf, f, 11, cuda)
    o, lse = banded_flash_attention(q, k, v, g, tpf, w, return_lse=True)
    do = torch.from_numpy(np.random.RandomState(12).randn(*q.shape).astype(np.float32)).to(cuda, torch.bfloat16)
    before = (native.launches("banded_flash_attention_bwd"), native.launches("flash_attention_bwd"))
    got = banded_flash_attention_bwd(q, k, v, o, lse, do, g, tpf, w)
    want = banded_flash_attention_bwd_reference(q, k, v, o, lse, do, g, tpf, w)
    torch.cuda.synchronize()
    # the video queries' banded kernels and the global queries' B2
    assert (native.launches("banded_flash_attention_bwd"), native.launches("flash_attention_bwd")) == (
        before[0] + 1, before[1] + 1)
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
    before = (native.launches("banded_flash_attention"), native.launches("banded_flash_attention_bwd"))
    with pytest.raises(ValueError):
        banded_flash_attention(q.double(), k.double(), v.double(), 24, 20, 1)
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
    assert (native.launches("banded_flash_attention"), native.launches("banded_flash_attention_bwd")) == before


# B6 and B7 (one SP shard of video-query frames at a runtime frame offset)
# against their plain versions at every offset of a 2- and a 4-rank ring,
# dummy frames included, held to B4's and B5's bars
def _shard(x, g, tpf, f, f_loc, off):
    """The shard's video rows of x, zero past the clip (the dummy frames, as
    the SP wrapper takes them)."""
    import torch.nn.functional as F

    rows = x[:, g + off * tpf:g + min(off + f_loc, f) * tpf]
    return F.pad(rows, (0, 0, 0, 0, 0, f_loc * tpf - rows.shape[1]))


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
        before = native.launches("banded_flash_attention_local")
        o, lse = banded_flash_attention_local(q_loc, k, v, g, tpf, w, off, f, return_lse=True)
        o_ref, lse_ref = banded_flash_attention_local_reference(q_loc, k, v, g, tpf, w, off, f, return_lse=True)
        torch.cuda.synchronize()
        assert native.launches("banded_flash_attention_local") == before + 1
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
        before = native.launches("banded_flash_attention_local_bwd")
        got = banded_flash_attention_local_bwd(q_loc, k, v, o, lse, do_loc, g, tpf, w, off, f)
        want = banded_flash_attention_local_bwd_reference(q_loc, k, v, o, lse, do_loc, g, tpf, w, off, f)
        torch.cuda.synchronize()
        assert native.launches("banded_flash_attention_local_bwd") == before + 1
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
    before = (native.launches("banded_flash_attention_local"), native.launches("banded_flash_attention_local_bwd"))
    # a negative offset (an offset past F is a shard of dummy frames, which runs)
    with pytest.raises(ValueError):
        banded_flash_attention_local(q_loc, k, v, g, tpf, 1, -1, f)
    with pytest.raises(ValueError):
        banded_flash_attention_local_bwd(q_loc, k, v, o, lse, o, g, tpf, 1, -1, f)
    with pytest.raises(ValueError):
        banded_flash_attention_local(q_loc.double(), k.double(), v.double(), g, tpf, 1, 0, f)
    with pytest.raises(ValueError):
        banded_flash_attention_local(q_loc[..., :32], k[..., :32], v[..., :32], g, tpf, 1, 0, f)
    with pytest.raises(ValueError):
        banded_flash_attention_local(q_loc, k, v, g, tpf, 1, 0, f + 1)
    with pytest.raises(ValueError):
        banded_flash_attention_local_bwd(q_loc, k, v, o, lse.to(torch.bfloat16), o, g, tpf, 1, 0, f)
    assert (native.launches("banded_flash_attention_local"),
            native.launches("banded_flash_attention_local_bwd")) == before


def test_sp_windowed_on_one_rank_matches_plain_autograd(cuda):
    """``sp_windowed`` on a one-rank NCCL group (a ``HashStore``, no network):
    the output and the grads of its autograd Function (B6/B1 forward,
    B7/B2 backward, the collectives) against plain autograd of the masked
    reference."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from s2v_torch.ops.windowed_attention import windowed_attention_reference as reference
    from s2v_torch.parallel.context import FrameShard
    from s2v_torch.parallel.sp_attention import banded_allgather_attention_trainable

    started = not dist.is_initialized()
    if started:
        dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("seq",))
        g, tpf, f, w = 40, 100, 5, 1
        q, k, v = (x.requires_grad_() for x in _band_qkv(g, tpf, f, 26, cuda))
        do = torch.from_numpy(np.random.RandomState(27).randn(*q.shape).astype(np.float32)).to(cuda, torch.bfloat16)
        before = (native.launches("banded_flash_attention_local"), native.launches("banded_flash_attention_local_bwd"))
        shard = FrameShard(f, tpf, 1, 0, mesh.get_group("seq"))
        o = banded_allgather_attention_trainable(q, k, v, shard, g, w)
        got = torch.autograd.grad(o, (q, k, v), do)
        leaves = [x.detach().float().requires_grad_() for x in (q, k, v)]
        o_ref = reference(*leaves, g, tpf, w)
        want = torch.autograd.grad(o_ref, leaves, do.float())
        torch.cuda.synchronize()
        assert (native.launches("banded_flash_attention_local"),
                native.launches("banded_flash_attention_local_bwd")) == (before[0] + 1, before[1] + 1)
        _assert_close(o, o_ref)
        for a, r in zip(got, want):
            _assert_close(a, r)
    finally:
        if started:
            dist.destroy_process_group()


@pytest.mark.parametrize("backend", ["sp_allgather", "sp_ulysses", "ring", "sp_int8"])
def test_exact_sp_backends_on_one_rank_match_plain(cuda, backend):
    """The exact sequence-parallel backends on a one-rank NCCL group: the
    output (and, but for sp_int8, the grads of their autograd Functions)
    against plain fp32 autograd of exact attention; sp_int8 against B3's
    plain version."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from s2v_torch.kernels.int8_attention import flash_attention_qk_int8_reference
    from s2v_torch.parallel.context import FrameShard
    from s2v_torch.parallel.ring_attention import ring_attention_trainable
    from s2v_torch.parallel.sp_attention import (
        allgather_kv_attention_trainable,
        int8_allgather_attention,
        ulysses_attention_trainable,
    )

    fn = {"sp_allgather": allgather_kv_attention_trainable, "sp_ulysses": ulysses_attention_trainable,
          "ring": ring_attention_trainable, "sp_int8": int8_allgather_attention}[backend]
    started = not dist.is_initialized()
    if started:
        dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("seq",))
        g, tpf, f = 40, 100, 5
        shard = FrameShard(f, tpf, 1, 0, mesh.get_group("seq"))
        q, k, v = _band_qkv(g, tpf, f, 28, cuda)
        if backend == "sp_int8":
            _assert_close(fn(q, k, v, shard, g), flash_attention_qk_int8_reference(q, k, v))
            return
        q, k, v = (x.requires_grad_() for x in (q, k, v))
        do = torch.from_numpy(np.random.RandomState(29).randn(*q.shape).astype(np.float32)).to(cuda, torch.bfloat16)
        o = fn(q, k, v, shard, g)
        got = torch.autograd.grad(o, (q, k, v), do)
        leaves = [x.detach().float().requires_grad_() for x in (q, k, v)]
        o_ref = flash_attention_reference(*leaves)
        want = torch.autograd.grad(o_ref, leaves, do.float())
        torch.cuda.synchronize()
        _assert_close(o, o_ref)
        for a, r in zip(got, want):
            _assert_close(a, r)
    finally:
        if started:
            dist.destroy_process_group()


@pytest.mark.parametrize("sq,block_q", [(300, 128), (77, 1024)])
def test_chunked_matches_b1_b2_and_plain_autograd(cuda, sq, block_q):
    """The ``chunked`` backend (PyTorch ops, per-block checkpoint) on bf16
    inputs: its output and autograd grads against B1/B2
    (``flash_attention_trainable``) and against plain fp32 autograd."""
    from s2v_torch.ops.attention import chunked_attention

    q, k, v = (x.requires_grad_() for x in _qkv(1, sq, sq, 3, 30, cuda))
    do = torch.from_numpy(np.random.RandomState(31).randn(*q.shape).astype(np.float32)).to(cuda, torch.bfloat16)
    o = chunked_attention(q, k, v, block_q=block_q)
    got = torch.autograd.grad(o, (q, k, v), do)
    before = (native.launches("flash_attention"), native.launches("flash_attention_bwd"))
    o_kernel = flash_attention_trainable(q, k, v)
    kernel = torch.autograd.grad(o_kernel, (q, k, v), do)
    leaves = [x.detach().float().requires_grad_() for x in (q, k, v)]
    o_ref = flash_attention_reference(*leaves)
    want = torch.autograd.grad(o_ref, leaves, do.float())
    torch.cuda.synchronize()
    assert (native.launches("flash_attention"), native.launches("flash_attention_bwd")) == (
        before[0] + 1, before[1] + 1)
    _assert_close(o, o_ref)
    _assert_close(o, o_kernel)
    for a, b, r in zip(got, kernel, want):
        _assert_close(a, r)
        _assert_close(a, b)


@pytest.mark.parametrize("kw", [dict(), dict(use_dpm=True), dict(adaptive_threshold=1e9),
                                dict(use_dynamic_cfg=True, cfg_skip_threshold=0.05)],
                         ids=["ddim", "dpm", "adaptive", "cfg_skip"])
def test_segmented_generate_equals_the_whole_loop(cuda, kw):
    """A small bf16 pipeline with d = 64 heads on the card (B1 in every
    forward): segments of 1 and 2 steps give the whole loop's latents bit
    for bit."""
    from s2v_torch import S2VPipeline, TransformerConfig, VAEConfig
    from s2v_torch.models.transformer import init_transformer_params_random
    from s2v_torch.models.vae import init_vae_params_random

    tcfg = TransformerConfig.tiny(num_attention_heads=2, attention_head_dim=64, dtype=torch.bfloat16)
    vcfg = VAEConfig.tiny(latent_channels=4, sample_height=64, sample_width=64, dtype=torch.bfloat16)
    pipe = S2VPipeline(init_transformer_params_random(tcfg, seed=3, device=cuda, scale=0.1), tcfg,
                       init_vae_params_random(vcfg, seed=4, device=cuda), vcfg, device=cuda)
    embeds = torch.from_numpy(np.random.RandomState(0).randn(2, 16, 32).astype(np.float32))
    args = dict(prompt_embeds=embeds, ref_latents=torch.zeros(1, 1, 4, 4, 4), height=32, width=32, num_frames=9,
                num_inference_steps=4, output_type="latent", seed=1, **kw)
    before = native.launches("flash_attention")
    whole = pipe.generate(**args)
    assert native.launches("flash_attention") > before
    for seg in (1, 2):
        assert torch.equal(pipe.generate(segment_steps=seg, **args), whole), seg
    assert torch.isfinite(whole.float()).all()


# B3 against its plain version on the same bf16 inputs and the same int8
# pre-pass: the logits are integer-exact in both, so what differs is exp2
# and the bf16 rounding of P before P·V and of the output: B1's bars.
@pytest.mark.parametrize("b,sq,skv,h", [(2, 200, 200, 3), (1, 77, 333, 2), (2, 1000, 129, 2), (1, 90, 90, 1)])
def test_int8_kernel_matches_plain(cuda, b, sq, skv, h):
    q, k, v = _qkv(b, sq, skv, h, 16, cuda)
    before = native.launches("flash_attention_qk_int8")
    o = flash_attention_qk_int8(q, k, v)
    o_ref = flash_attention_qk_int8_reference(q, k, v)
    torch.cuda.synchronize()
    assert native.launches("flash_attention_qk_int8") == before + 1
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
    before = native.launches("flash_attention_qk_int8")
    with pytest.raises(ValueError):
        flash_attention_qk_int8(q.double(), k.double(), v.double())
    with pytest.raises(ValueError):
        flash_attention_qk_int8(q[..., :32], k[..., :32], v[..., :32])
    shifted = torch.empty(v.numel() + 1, dtype=v.dtype, device=cuda)[1:].view(v.shape)
    with pytest.raises(ValueError):
        flash_attention_qk_int8(q, k, shifted)
    with pytest.raises(ValueError):
        flash_attention_qk_int8(q, k[:, :0], v[:, :0])
    assert native.launches("flash_attention_qk_int8") == before


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
    before = native.launches("flash_attention_qk_int8_prepass")
    got = launch_int8_prepass(q, k, 0.125)
    want = int8_prepass(q, k, 0.125)
    torch.cuda.synchronize()
    assert native.launches("flash_attention_qk_int8_prepass") == before + 1
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


# ---- fp16 (the 2b family): B1 and B2 take fp16 as they take bf16 ----
# fp16 inputs against the same fp32 plain versions; the kernels round P (and
# dS) to fp16 (relative 2^-11, finer than bf16's 2^-8), so the bf16 bars hold.


def _qkv16(b, sq, skv, h, seed, device):
    return tuple(x.to(torch.float16) for x in _qkv(b, sq, skv, h, seed, device))


@pytest.mark.parametrize("mode", ["online", "bounded", "bounded_exp2"])
@pytest.mark.parametrize("sq,skv,masked", [(200, 200, False), (77, 333, True), (1000, 129, False)])
def test_kernel_fp16_matches_plain(cuda, mode, sq, skv, masked):
    q, k, v = _qkv16(2, sq, skv, 3, 20, cuda)
    mask = None
    if masked:
        mask = torch.zeros(skv, dtype=torch.bool, device=cuda)
        mask[3:30] = True
    before, reruns = native.launches("flash_attention", "float16"), native.launches("flash_attention_rerun")
    o, lse = flash_attention(q, k, v, return_lse=True, key_pad_mask=mask, softmax_mode=mode)
    o_ref, lse_ref = flash_attention_reference(q, k, v, return_lse=True, key_pad_mask=mask, softmax_mode=mode)
    torch.cuda.synchronize()
    # one launch, and one more if the bounded guard re-ran the call online
    launched = native.launches("flash_attention", "float16") - before
    assert o.dtype == torch.float16 and launched == 1 + native.launches("flash_attention_rerun") - reruns
    _assert_close(o, o_ref)
    assert (lse - lse_ref).abs().max().item() < 1e-3


@pytest.mark.parametrize("sq,skv", [(200, 200), (77, 333), (1000, 129)])
def test_bwd_kernel_fp16_matches_plain_and_schedule(cuda, sq, skv):
    q, k, v = _qkv16(2, sq, skv, 3, 21, cuda)
    o, lse = flash_attention(q, k, v, return_lse=True, softmax_mode="bounded")
    do = torch.from_numpy(np.random.RandomState(22).randn(*q.shape).astype(np.float32)).to(cuda, torch.float16)
    got = flash_attention_bwd(q, k, v, o, lse, do)
    again = flash_attention_bwd(q, k, v, o, lse, do)
    want = flash_attention_bwd_reference(q, k, v, o, lse, do)
    emulated = flash_attention_bwd_blocked(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    for a, b, w, e, x in zip(got, again, want, emulated, (q, k, v)):
        assert a.shape == x.shape and a.dtype == torch.float16 and torch.equal(a, b)
        _assert_close(a, w)
        _assert_close(a, e)


@pytest.mark.parametrize("mode", ["bounded", "bounded_exp2"])
@pytest.mark.parametrize("sq,skv", [(200, 200), (77, 333), (1000, 129)])
def test_kernel_fp16_bounded_without_rerun(cuda, mode, sq, skv):
    """Layer-normed q and k, as after the DiT's qk-norm: M0 is 8 nats and
    every row's largest logit lies within 15 bits of it, so the bounded
    fp16 kernel's own result stands (no online re-run)."""
    q, k, v = _qkv16(2, sq, skv, 3, 29, cuda)
    q, k = (torch.nn.functional.layer_norm(x.float(), (64,)).half() for x in (q, k))
    reruns = native.launches("flash_attention_rerun")
    o, lse = flash_attention(q, k, v, return_lse=True, softmax_mode=mode)
    o_ref, lse_ref = flash_attention_reference(q, k, v, return_lse=True, softmax_mode=mode)
    torch.cuda.synchronize()
    assert native.launches("flash_attention_rerun") == reruns
    _assert_close(o, o_ref)
    assert (lse - lse_ref).abs().max().item() < 1e-3


@pytest.mark.parametrize("mode", ["bounded", "bounded_exp2"])
def test_kernel_fp16_bounded_rows_far_below_m0(cuda, mode):
    """One q row scaled x4 puts M0 ~40 nats above every other row's largest
    logit: rounded to fp16 there, those rows' P would flush to zero and
    their output shrink to it.  The fp16 kernel flags the rows, and the
    guard re-runs the call online."""
    q, k, v = _qkv16(1, 300, 300, 2, 26, cuda)
    q[:, 0] *= 4
    before = native.launches("flash_attention_rerun")
    o, lse = flash_attention(q, k, v, return_lse=True, softmax_mode=mode)
    o_ref, lse_ref = flash_attention_reference(q, k, v, return_lse=True, softmax_mode=mode)
    torch.cuda.synchronize()
    assert native.launches("flash_attention_rerun") == before + 1
    _assert_close(o, o_ref)
    assert (lse - lse_ref).abs().max().item() < 1e-3


def test_bwd_kernel_fp16_small_do(cuda):
    """fp16 B2 at dO 2^-14 of unit normal over 1,000 layer-normed keys,
    where the fp32 dS sits near fp16's flush point: the kernels' dS, scaled
    by a power of two before its rounding, keeps dq and dk within the limits
    of the plain version (fp16 outputs, near fp16's normal range) and of the
    emulation of the schedule."""
    q, k, v = _qkv16(1, 1000, 1000, 2, 27, cuda)
    q, k = (torch.nn.functional.layer_norm(x.float(), (64,)).half() for x in (q, k))
    o, lse = flash_attention(q, k, v, return_lse=True, softmax_mode="bounded")
    do = (torch.from_numpy(np.random.RandomState(28).randn(*q.shape).astype(np.float32)) * 2.0 ** -14).to(
        cuda, torch.float16)
    got = flash_attention_bwd(q, k, v, o, lse, do)
    want = flash_attention_bwd_reference(q, k, v, o, lse, do)
    emulated = flash_attention_bwd_blocked(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    for a, w, e in zip(got, want, emulated):
        assert a.dtype == torch.float16 and bool((a != 0).any())
        scale = w.float().abs().max().item()
        for ref in (w, e):
            diff = a.float() - ref.float()
            assert diff.abs().max().item() <= 2.0 ** -6 * scale
            assert (diff.norm() / ref.float().norm()).item() < L2_REL


def test_flash_trainable_fp16_matches_autograd(cuda):
    """The flash backend's autograd pair (B1 forward, B2 backward) in fp16
    against plain autograd in fp32 on the same fp16 values."""
    q, k, v = (x.requires_grad_() for x in _qkv16(1, 300, 300, 2, 23, cuda))
    do = torch.from_numpy(np.random.RandomState(24).randn(*q.shape).astype(np.float32)).to(cuda, torch.float16)
    out = flash_attention_trainable(q, k, v)
    grads = torch.autograd.grad(out, (q, k, v), do)
    qf, kf, vf = (x.detach().float().requires_grad_() for x in (q, k, v))
    ref = flash_attention_reference(qf, kf, vf)
    ref_grads = torch.autograd.grad(ref, (qf, kf, vf), do.float())
    assert out.dtype == torch.float16
    _assert_close(out, ref)
    for g, r in zip(grads, ref_grads):
        assert g.dtype == torch.float16
        _assert_close(g, r)


# ---- fp16 in B3-B7 (the 2b family with the int8 and windowed backends) ----
# fp16 inputs against the fp32 plain versions and the emulations of the
# schedules (P, and dS scaled by 2^e, rounded to fp16): the bars of B1/B2.


def _fp16_limits(a, ref):
    """The kernel limits scaled to the reference (ROADMAP C.1): max error at
    most 2^-6 of its largest element, relative L2 below 1e-2."""
    diff = a.float() - ref.float()
    assert diff.abs().max().item() <= 2.0 ** -6 * ref.float().abs().max().item()
    assert (diff.norm() / ref.float().norm()).item() < L2_REL


@pytest.mark.parametrize("g,tpf,f,w", BANDS)
def test_banded_kernels_fp16_match_plain_and_schedule(cuda, g, tpf, f, w):
    q, k, v = (x.half() for x in _band_qkv(g, tpf, f, 40, cuda))
    before = (native.launches("banded_flash_attention", "float16"),
              native.launches("banded_flash_attention_bwd", "float16"))
    o, lse = banded_flash_attention(q, k, v, g, tpf, w, return_lse=True)
    o_ref, lse_ref = banded_flash_attention_reference(q, k, v, g, tpf, w, return_lse=True)
    o_emu = banded_flash_attention_blocked(q, k, v, g, tpf, w)
    do = torch.from_numpy(np.random.RandomState(41).randn(*q.shape).astype(np.float32)).to(cuda, torch.float16)
    got = banded_flash_attention_bwd(q, k, v, o, lse, do, g, tpf, w)
    want = banded_flash_attention_bwd_reference(q, k, v, o, lse, do, g, tpf, w)
    emulated = banded_flash_attention_bwd_blocked(q, k, v, o, lse, do, g, tpf, w)
    torch.cuda.synchronize()
    assert (native.launches("banded_flash_attention", "float16"),
            native.launches("banded_flash_attention_bwd", "float16")) == (before[0] + 1, before[1] + 1)
    assert o.dtype == torch.float16
    _assert_close(o, o_ref)
    _assert_close(o, o_emu)
    assert (lse - lse_ref).abs().max().item() < 1e-2
    for a, r, e in zip(got, want, emulated):
        assert a.dtype == torch.float16
        _assert_close(a, r)
        _assert_close(a, e)


@pytest.mark.parametrize("g,tpf,f,w", BANDS)
def test_banded_local_kernels_fp16_match_plain_and_schedule(cuda, g, tpf, f, w):
    q, k, v = (x.half() for x in _band_qkv(g, tpf, f, 42, cuda))
    do = torch.from_numpy(np.random.RandomState(43).randn(*q.shape).astype(np.float32)).to(cuda, torch.float16)
    for f_loc, off in _ring_shards(f):
        q_loc, do_loc = _shard(q, g, tpf, f, f_loc, off), _shard(do, g, tpf, f, f_loc, off)
        o, lse = banded_flash_attention_local(q_loc, k, v, g, tpf, w, off, f, return_lse=True)
        o_ref = banded_flash_attention_local_reference(q_loc, k, v, g, tpf, w, off, f)
        o_emu = banded_flash_attention_blocked(q_loc, k, v, g, tpf, w, frame_offset=off, n_frames_total=f)
        got = banded_flash_attention_local_bwd(q_loc, k, v, o, lse, do_loc, g, tpf, w, off, f)
        want = banded_flash_attention_local_bwd_reference(q_loc, k, v, o, lse, do_loc, g, tpf, w, off, f)
        emulated = banded_flash_attention_bwd_blocked(q_loc, k, v, o, lse, do_loc, g, tpf, w, frame_offset=off,
                                                      n_frames_total=f)
        torch.cuda.synchronize()
        assert o.dtype == torch.float16
        _assert_close(o, o_ref)
        _assert_close(o, o_emu)
        for a, r, e in zip(got, want, emulated):
            assert a.dtype == torch.float16
            if not r.any():  # a partial that no query of the shard's band reaches
                assert not a.any()
                continue
            _assert_close(a, r)
            _assert_close(a, e)


def test_banded_bwd_kernels_fp16_small_do(cuda):
    """fp16 B5, and B7 at each shard of a 2-rank ring, at dO 2^-14 of unit
    normal over ~1,000 layer-normed keys a query, where the fp32 dS sits
    near fp16's flush point: the dS scaled before its rounding keeps dq and
    dk within the limits of the plain version and of the schedule."""
    g, tpf, f, w = 250, 250, 5, 1
    q, k, v = _qkv16(1, g + f * tpf, g + f * tpf, 2, 44, cuda)
    q, k = (torch.nn.functional.layer_norm(x.float(), (64,)).half() for x in (q, k))
    do = (torch.from_numpy(np.random.RandomState(45).randn(*q.shape).astype(np.float32)) * 2.0 ** -14).to(
        cuda, torch.float16)
    o, lse = banded_flash_attention(q, k, v, g, tpf, w, return_lse=True)
    cases = [(banded_flash_attention_bwd(q, k, v, o, lse, do, g, tpf, w),
              banded_flash_attention_bwd_reference(q, k, v, o, lse, do, g, tpf, w),
              banded_flash_attention_bwd_blocked(q, k, v, o, lse, do, g, tpf, w))]
    for off, n in ((0, 3), (3, 2)):
        rows = slice(g + off * tpf, g + (off + n) * tpf)
        args = (q[:, rows], k, v, o[:, rows], lse[..., rows].contiguous(), do[:, rows], g, tpf, w)
        cases.append((banded_flash_attention_local_bwd(*args, off, f),
                      banded_flash_attention_local_bwd_reference(*args, off, f),
                      banded_flash_attention_bwd_blocked(*args, frame_offset=off, n_frames_total=f)))
    torch.cuda.synchronize()
    for got, want, emulated in cases:
        for a, r, e in zip(got, want, emulated):
            assert a.dtype == torch.float16 and bool((a != 0).any())
            _fp16_limits(a, r)
            _fp16_limits(a, e)


@pytest.mark.parametrize("b,sq,skv,h", [(2, 200, 182, 3), (1, 77, 333, 2), (1, 300, 54, 2), (2, 129, 128, 1)])
def test_int8_kernel_fp16_matches_plain_and_schedule(cuda, b, sq, skv, h):
    """B3 on fp16 q/k/v: its fp16 pre-pass equal to the plain pre-pass bit
    for bit, the output fp16 within the bars of the plain version and of the
    schedule's emulation (P rounded to fp16)."""
    q, k, v = _qkv16(b, sq, skv, h, 46, cuda)
    scale = 64 ** -0.5
    for got, want in zip(launch_int8_prepass(q, k, scale), int8_prepass(q, k, scale)):
        assert torch.equal(got, want)
    before = native.launches("flash_attention_qk_int8", "float16")
    o = flash_attention_qk_int8(q, k, v)
    torch.cuda.synchronize()
    assert native.launches("flash_attention_qk_int8", "float16") == before + 1
    assert o.dtype == torch.float16
    _assert_close(o, flash_attention_qk_int8_reference(q, k, v))
    _assert_close(o, flash_attention_qk_int8_blocked(q, k, v))


def test_bf16_only_kernels_refuse_fp16_on_the_card(cuda):
    """No fallback and no cast: fp32 reaching B3 or B4 launches its fp32 form
    (and returns fp32), and the flash_int8/windowed backends hand fp16 to
    B3/B4 uncast on the card (each launches its fp16 entry and returns
    fp16); fp32 through either backend runs the fp32 kernel."""
    from s2v_torch.ops.attention import joint_attention

    q, k, v = _qkv16(1, 200, 200, 2, 25, cuda)
    before = native.launches("flash_attention_qk_int8", "float32")
    assert flash_attention_qk_int8(q.float(), k.float(), v.float()).dtype == torch.float32
    assert native.launches("flash_attention_qk_int8", "float32") == before + 1
    before = native.launches("banded_flash_attention", "float32")
    assert banded_flash_attention(q.float(), k.float(), v.float(), 40, 40, 1).dtype == torch.float32
    assert native.launches("banded_flash_attention", "float32") == before + 1
    d = 2 * 64
    params = {"qkv": {"weight": torch.randn(3 * d, d, device=cuda, dtype=torch.float16) * 0.05,
                      "bias": torch.zeros(3 * d, device=cuda, dtype=torch.float16)},
              "norm_q": {"weight": torch.ones(64, device=cuda, dtype=torch.float16),
                         "bias": torch.zeros(64, device=cuda, dtype=torch.float16)},
              "norm_k": {"weight": torch.ones(64, device=cuda, dtype=torch.float16),
                         "bias": torch.zeros(64, device=cuda, dtype=torch.float16)},
              "to_out": {"weight": torch.randn(d, d, device=cuda, dtype=torch.float16) * 0.05,
                         "bias": torch.zeros(d, device=cuda, dtype=torch.float16)}}
    x = torch.randn(1, 200, d, device=cuda, dtype=torch.float16)
    for backend, window, kernel in (("flash_int8", None, "flash_attention_qk_int8"),
                                    ("windowed", (40, 40, 1), "banded_flash_attention")):
        before = native.launches(kernel, "float16")
        assert joint_attention(params, x, 2, backend=backend, window=window).dtype == torch.float16
        assert native.launches(kernel, "float16") == before + 1
        fp32_params = {k: {n: t.float() for n, t in leaf.items()} for k, leaf in params.items()}
        before = native.launches(kernel, "float32")
        assert joint_attention(fp32_params, x.float(), 2, backend=backend, window=window).dtype == torch.float32
        assert native.launches(kernel, "float32") == before + 1
    assert joint_attention(params, x, 2, backend="flash").dtype == torch.float16


# fp32 (ROADMAP C.1): the 3xTF32 kernels of csrc/attention_f32.cu and
# attention_f32_bwd.cu against their plain versions with TF32 matmuls off and
# against the emulations of their schedules; the chip smoke's limits
FP32_FWD = (2.0 ** -14, 2e-5)
FP32_BWD = (2.0 ** -12, 1e-4)


def _close_f32(x, ref, limits):
    max_rel, l2 = limits
    x, ref = x.double(), ref.double()
    if not ref.abs().max().item():
        assert not x.abs().max().item()
        return
    diff = x - ref
    assert diff.abs().max().item() <= max_rel * ref.abs().max().item()
    assert (diff.norm() / ref.norm()).item() < l2


@pytest.fixture
def no_tf32(cuda):
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield cuda
    torch.backends.cuda.matmul.allow_tf32 = saved


def _f32(shape, seed, device):
    return torch.from_numpy(np.random.RandomState(seed).randn(*shape).astype(np.float32)).to(device)


@pytest.mark.parametrize("mode", ["online", "bounded", "bounded_exp2"])
def test_fp32_b1_b2_match_plain_and_emulation(no_tf32, mode):
    from s2v_torch.kernels import attention_f32 as af

    q, k, v = (_f32((2, s, 3, 64), i, no_tf32) for i, s in enumerate((200, 333, 333)))
    mask = torch.zeros(333, dtype=torch.bool, device=no_tf32)
    mask[7:40] = True
    before = native.launches("flash_attention", "float32")
    o, lse = flash_attention(q, k, v, return_lse=True, key_pad_mask=mask, softmax_mode=mode)
    assert o.dtype == torch.float32 and native.launches("flash_attention", "float32") > before
    o_ref, lse_ref = flash_attention_reference(q, k, v, return_lse=True, key_pad_mask=mask, softmax_mode=mode)
    _close_f32(o, o_ref, FP32_FWD)
    _close_f32(o, af.flash_attention_f32_blocked(q, k, v, key_pad_mask=mask, softmax_mode=mode), FP32_FWD)
    assert (lse - lse_ref).abs().max().item() < 1e-4
    o, lse = flash_attention(q, k, v, return_lse=True, softmax_mode=mode)
    do = _f32(q.shape, 9, no_tf32)
    got = flash_attention_bwd(q, k, v, o, lse, do)
    again = flash_attention_bwd(q, k, v, o, lse, do)
    for a, r, e, b in zip(got, flash_attention_bwd_reference(q, k, v, o, lse, do),
                          af.flash_attention_bwd_f32_blocked(q, k, v, o, lse, do), again):
        _close_f32(a, r, FP32_BWD)
        _close_f32(a, e, FP32_BWD)
        assert torch.equal(a, b)


def test_fp32_b4_to_b7_match_plain(no_tf32):
    g, tpf, f, w = 40, 100, 5, 1
    s = g + f * tpf
    q, k, v, do = (_f32((1, s, 2, 64), i + 20, no_tf32) for i in range(4))
    o, lse = banded_flash_attention(q, k, v, g, tpf, w, return_lse=True)
    o_ref = banded_flash_attention_reference(q, k, v, g, tpf, w)
    _close_f32(o, o_ref, FP32_FWD)
    for a, r in zip(banded_flash_attention_bwd(q, k, v, o, lse, do, g, tpf, w),
                    banded_flash_attention_bwd_reference(q, k, v, o, lse, do, g, tpf, w)):
        _close_f32(a, r, FP32_BWD)
    for ring in (2, 4, 8):  # 8 ranks over 5 frames: ranks 5-7 hold dummy frames only
        _, f_loc = ring_shards(f, ring)
        for r in range(ring):
            off = r * f_loc
            lo, hi = g + off * tpf, g + (off + f_loc) * tpf
            q_loc = torch.nn.functional.pad(q[:, lo:hi], (0, 0, 0, 0, 0, f_loc * tpf - q[:, lo:hi].shape[1]))
            do_loc = torch.nn.functional.pad(do[:, lo:hi], (0, 0, 0, 0, 0, f_loc * tpf - do[:, lo:hi].shape[1]))
            o_l, lse_l = banded_flash_attention_local(q_loc, k, v, g, tpf, w, off, f, return_lse=True)
            o_lr = banded_flash_attention_local_reference(q_loc, k, v, g, tpf, w, off, f)
            _close_f32(o_l, o_lr, FP32_FWD)
            args = (q_loc, k, v, o_l, lse_l, do_loc, g, tpf, w, off, f)
            for a, r_ in zip(banded_flash_attention_local_bwd(*args), banded_flash_attention_local_bwd_reference(*args)):
                _close_f32(a, r_, FP32_BWD)


# ragged fp32 shapes of the redesigned kernels: Sq != Skv, lengths off the
# 128-row blocks and the 64-key (forward) and 32-row (backward) tiles
FP32_RAGGED = [(1, 77, 333, 2), (2, 1000, 129, 2), (1, 130, 40, 2), (1, 129, 257, 1)]


@pytest.mark.parametrize("b,sq,skv,h", FP32_RAGGED)
def test_fp32_b1_b2_ragged_match_plain_and_emulation(no_tf32, b, sq, skv, h):
    from s2v_torch.kernels import attention_f32 as af

    q, k, v = (_f32((b, s, h, 64), s + i, no_tf32) for i, s in enumerate((sq, skv, skv)))
    o, lse = flash_attention(q, k, v, return_lse=True, softmax_mode="online")
    _close_f32(o, flash_attention_reference(q, k, v), FP32_FWD)
    _close_f32(o, af.flash_attention_f32_blocked(q, k, v), FP32_FWD)
    do = _f32(q.shape, 3, no_tf32)
    got = flash_attention_bwd(q, k, v, o, lse, do)
    for a, r, e, again in zip(got, flash_attention_bwd_reference(q, k, v, o, lse, do),
                              af.flash_attention_bwd_f32_blocked(q, k, v, o, lse, do),
                              flash_attention_bwd(q, k, v, o, lse, do)):
        _close_f32(a, r, FP32_BWD)
        _close_f32(a, e, FP32_BWD)
        assert torch.equal(a, again)


@pytest.mark.parametrize("b,sq,skv,h", [(2, 90, 90, 2), (1, 77, 200, 3), (2, 200, 33, 1), (1, 300, 1000, 2)])
def test_int8_kernel_fp32_matches_plain_and_schedule(no_tf32, b, sq, skv, h):
    """B3's fp32 form: the pre-pass kernels' int8 values and dq equal to the
    plain pre-pass's, the kernel within the fp32 limits of the plain version
    and of its schedule's emulation, two launches bit for bit."""
    q, k, v = (_f32((b, s, h, 64), 40 + i + s, no_tf32) for i, s in enumerate((sq, skv, skv)))
    for got, want in zip(launch_int8_prepass(q, k, 0.125), int8_prepass(q, k, 0.125)):
        assert torch.equal(got, want)
    before = native.launches("flash_attention_qk_int8", "float32")
    o = flash_attention_qk_int8(q, k, v)
    assert o.dtype == torch.float32 and native.launches("flash_attention_qk_int8", "float32") == before + 1
    _close_f32(o, flash_attention_qk_int8_reference(q, k, v), FP32_FWD)
    _close_f32(o, flash_attention_qk_int8_blocked(q, k, v), FP32_FWD)
    assert torch.equal(o, flash_attention_qk_int8(q, k, v))


@pytest.mark.parametrize("d_in,d_out,rows", [(20, 36, 5), (7, 13, 300), (64, 40, 33)])
def test_int8_dense_any_width_on_cuda_equals_cpu(cuda, d_in, d_out, rows):
    """The int8 linears at widths that are not multiples of 8: the card pads
    the operands (zero columns, zero rows of q); its int32 products equal
    the CPU's bit for bit, and its fp32 outputs meet
    ``test_int8_dense_on_cuda_matches_cpu``'s fp32 bar."""
    from s2v_torch.ops.quant import _int_mm, int8_dense, quantize_weight_int8

    rng = np.random.RandomState(d_in * d_out + rows)
    xq = torch.from_numpy(rng.randint(-127, 128, (rows, d_in)).astype(np.int8))
    q = torch.from_numpy(rng.randint(-127, 128, (d_out, d_in)).astype(np.int8))
    assert torch.equal(_int_mm(xq.to(cuda), q.to(cuda)).cpu(), _int_mm(xq, q))
    x = torch.from_numpy(rng.randn(1, rows, d_in).astype(np.float32))
    wq = quantize_weight_int8(torch.from_numpy(0.05 * rng.randn(d_out, d_in).astype(np.float32)))
    got = int8_dense(x.to(cuda), {n: t.to(cuda) for n, t in wq.items()}).cpu()
    want = int8_dense(x, wq)
    assert got.shape == (1, rows, d_out)
    assert ((got - want).abs() <= 1e-6 * want.abs() + 1e-6 * want.abs().max()).all()
