"""The CUDA backward's blocked schedule, emulated in PyTorch
(``flash_attention_bwd_blocked``: 64-key tiles in order for dq, 64-query
tiles in order for dk/dv, P and dS rounded to bf16 where the kernels feed
them to wgmma), against the plain version and the JAX Pallas backward in
interpret mode, at ragged shapes: Sq != Skv, lengths that are not whole
tiles, and fewer keys than one tile; and in fp16 at a small dO, where the
kernels scale dS by a power of two before its rounding.  The card holds the kernels to the
same emulation (tests/test_torch_gpu.py, chip_smoke.py)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from s2v_tpu.ops.pallas import flash_attention as j_fa_mod
from s2v_tpu.ops.pallas import flash_attention_bwd as j_fab_mod
from s2v_torch.kernels.flash_attention import flash_attention
from s2v_torch.kernels.flash_attention_bwd import (
    DS_BOUND_LOG2,
    ds_exponent,
    flash_attention_bwd_blocked,
    flash_attention_bwd_reference,
    row_delta,
)

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


def _layer_norm(x):
    return (x - x.mean(-1, keepdims=True)) / np.sqrt(x.var(-1, keepdims=True) + 1e-6)


def test_blocked_schedule_fp16_keeps_small_gradients():
    """fp16 inputs with dO at 2^-14 of unit normal (a training step's dO is
    small: the loss is a mean over ~10^6 latents, with no loss scaler).
    Over 1,000 keys the fp32 dS then sits near fp16's flush point (2^-25);
    the schedule scales it by 2^e (``ds_exponent``) before its fp16
    rounding, and dq, dk, dv stay within the limits of the plain version
    and of the JAX package's path for fp16 (the Pallas backward on the fp32
    upcast, its gradients cast back to fp16).  Rounded unscaled, dS moves
    dq and dk by about 2e-2 in relative L2, past the limit."""
    rng = np.random.RandomState(3)
    q, k, v = (rng.randn(1, 1000, 2, 64).astype(np.float32) for _ in range(3))
    q, k = _layer_norm(q), _layer_norm(k)
    q, k, v = (x.astype(np.float16) for x in (q, k, v))
    g = (rng.randn(1, 1000, 2, 64) * 2.0 ** -14).astype(np.float16)
    tq, tk, tv, tg = (torch.from_numpy(x) for x in (q, k, v, g))
    o, lse = flash_attention(tq, tk, tv, return_lse=True, softmax_mode="bounded")
    got = flash_attention_bwd_blocked(tq, tk, tv, o, lse, tg)
    want = flash_attention_bwd_reference(tq, tk, tv, o, lse, tg)
    f32 = [jnp.asarray(x.astype(np.float32)) for x in (q, k, v, g)]
    o_j, lse_j = j_fa_mod.flash_attention(*f32[:3], block_q=64, block_k=64, interpret=True, return_lse=True)
    want_jax = j_fab_mod.flash_attention_bwd(*f32[:3], o_j, lse_j, f32[3], block_q=64, block_k=64, interpret=True)
    for a, w, wj in zip(got, want, want_jax):
        assert a.dtype == torch.float16 and bool((a != 0).any())
        _assert_close(a.float().numpy(), w.float().numpy())
        _assert_close(a.float().numpy(), np.asarray(wj).astype(np.float16).astype(np.float32))


@pytest.mark.parametrize("log2_scale", [0, -20, 8])
def test_ds_exponent_bounds_the_scaled_ds(log2_scale):
    """The fp16 kernels' dS exponent e keeps 2^e·|dS| (fp32 dS of the plain
    backward) under 2^14, fp16 tops out at 65,504, and follows dO's scale
    exactly (a power of two)."""
    rng = np.random.RandomState(11)
    q, k, v, g = (torch.from_numpy(rng.randn(1, 150, 2, 64).astype(np.float32)) for _ in range(4))
    g = g * 2.0 ** log2_scale
    o, lse = flash_attention(q, k, v, return_lse=True)
    e = int(ds_exponent(v, g))
    assert e == int(ds_exponent(v, g * 2.0 ** -log2_scale)) - log2_scale
    qt, kt, vt, gt = (x.transpose(1, 2) for x in (q, k, v, g))
    p = torch.exp(qt @ kt.transpose(-1, -2) / 8.0 - lse[..., None])
    ds = p * (gt @ vt.transpose(-1, -2) - row_delta(o, g)[..., None])
    assert ds.abs().max().item() * 2.0 ** e <= 2.0 ** DS_BOUND_LOG2
