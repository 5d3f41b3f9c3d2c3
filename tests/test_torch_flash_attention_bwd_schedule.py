"""The CUDA backward's blocked schedule, emulated in PyTorch
(``flash_attention_bwd_blocked``: 64-key tiles in order for dq, 64-query
tiles in order for dk/dv, P and dS rounded to bf16 where the kernels feed
them to wgmma), against the plain version and the JAX Pallas backward in
interpret mode, at ragged shapes: Sq != Skv, lengths that are not whole
tiles, and fewer keys than one tile.  The card holds the kernels to the
same emulation (tests/test_torch_gpu.py, chip_smoke.py)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from s2v_tpu.ops.pallas import flash_attention as j_fa_mod
from s2v_tpu.ops.pallas import flash_attention_bwd as j_fab_mod
from s2v_torch.kernels.flash_attention import flash_attention
from s2v_torch.kernels.flash_attention_bwd import flash_attention_bwd_blocked, flash_attention_bwd_reference

# fp32 inputs; the emulation rounds P and dS to bf16 (relative 2^-9 each,
# 2^-8 after the product), so it is held to the card's limits for a kernel
# against its plain version: max error at most 2^-6 of the largest gradient
# element, relative L2 below 1e-2.  A dropped or repeated tile moves the
# relative L2 by several percent.
MAX_REL, L2_REL = 2.0 ** -6, 1e-2


def _assert_close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    diff = got - want
    assert np.abs(diff).max() <= MAX_REL * np.abs(want).max()
    assert np.linalg.norm(diff) / np.linalg.norm(want) < L2_REL


@pytest.mark.parametrize("sq,skv", [(77, 333), (1000, 129), (130, 40)],
                         ids=["ragged_sq_ne_skv", "long_q_short_k", "skv_below_one_tile"])
def test_blocked_schedule_matches_plain_and_pallas(sq, skv):
    rng = np.random.RandomState(sq * 7 + skv)
    q, k, v, g = (rng.randn(1, s, 2, 64).astype(np.float32) for s in (sq, skv, skv, sq))
    o, lse = j_fa_mod.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block_q=64, block_k=64,
                                      interpret=True, return_lse=True)
    want_jax = j_fab_mod.flash_attention_bwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), o, lse, jnp.asarray(g),
                                             block_q=64, block_k=64, interpret=True)
    args = [torch.from_numpy(np.array(x)) for x in (q, k, v, o, lse, g)]
    got = flash_attention_bwd_blocked(*args)
    want = flash_attention_bwd_reference(*args)
    for a, w, wj, x in zip(got, want, want_jax, (q, k, v)):
        assert a.shape == x.shape and a.dtype == torch.float32
        _assert_close(a.numpy(), w.numpy())
        _assert_close(a.numpy(), np.asarray(wj))


def test_blocked_schedule_sums_in_tile_order():
    """dq is the sum over 64-key tiles in order: the emulation of a key
    range split at a tile boundary equals the two halves' partials added in
    fp32, bit for bit; and it differs from the plain version (no bf16
    rounding there), so the rounding is really emulated."""
    rng = np.random.RandomState(3)
    q, k, v, g = (torch.from_numpy(rng.randn(1, s, 1, 64).astype(np.float32)) for s in (50, 128, 128, 50))
    o, lse = flash_attention(q, k, v, return_lse=True)
    dq, _, _ = flash_attention_bwd_blocked(q, k, v, o, lse, g)
    scale = 1.0 / 8.0
    # the per-tile dq partials (scale applied once, at the end, as the kernel does)
    c = scale * 1.4426950408889634
    lse2 = lse.float()[0, 0] * 1.4426950408889634
    delta = (g * o).sum(-1)[0, :, 0]
    acc = torch.zeros(50, 64)
    for k0 in (0, 64):
        kt, vt = k[0, k0:k0 + 64, 0], v[0, k0:k0 + 64, 0]
        p = torch.exp2(q[0, :, 0] @ kt.T * c - lse2[:, None])
        ds = (p * (g[0, :, 0] @ vt.T - delta[:, None])).to(torch.bfloat16).float()
        acc += ds @ kt
    assert torch.equal(dq[0, :, 0], acc * scale)
    assert not torch.equal(dq, flash_attention_bwd_reference(q, k, v, o, lse, g)[0])
