"""Kernel B1's plain PyTorch version (what the port runs on CPU tensors)
against the JAX Pallas kernel in interpret mode, on the same numpy inputs."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from s2v_tpu.ops.pallas.flash_attention import flash_attention as jax_flash_attention
from s2v_torch.kernels.flash_attention import (
    SOFTMAX_MODES,
    check_kernel_inputs,
    flash_attention,
)

# fp32 on both sides; the same bar as tests/test_flash_attention.py
ATOL, RTOL = 2e-5, 1e-4


def _inputs(b, sq, skv, h, seed, d=64):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, sq, h, d).astype(np.float32),
            rng.randn(b, skv, h, d).astype(np.float32),
            rng.randn(b, skv, h, d).astype(np.float32))


def _both(q, k, v, mask, mode):
    o_j, lse_j = jax_flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block_q=64, block_k=64, interpret=True,
        return_lse=True, key_pad_mask=None if mask is None else jnp.asarray(mask), softmax_mode=mode,
    )
    o_t, lse_t = flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), return_lse=True,
        key_pad_mask=None if mask is None else torch.from_numpy(mask), softmax_mode=mode,
    )
    return (np.asarray(o_j), np.asarray(lse_j)), (o_t.numpy(), lse_t.numpy())


@pytest.mark.parametrize("mode", SOFTMAX_MODES)
@pytest.mark.parametrize(
    "sq,skv,masked",
    [(128, 128, False), (150, 150, False), (70, 200, False), (96, 130, True)],
    ids=["aligned", "ragged", "sq_ne_skv", "key_pad_mask"],
)
def test_plain_matches_pallas(mode, sq, skv, masked):
    q, k, v = _inputs(1, sq, skv, 2, seed=sq + skv)
    mask = None
    if masked:
        mask = np.zeros(skv, bool)
        mask[10:30] = True
        mask[-5:] = True
    (o_j, lse_j), (o_t, lse_t) = _both(q, k, v, mask, mode)
    assert o_t.shape == q.shape and lse_t.shape == (1, 2, sq)
    np.testing.assert_allclose(o_t, o_j, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(lse_t, lse_j, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("mode", ["bounded", "bounded_exp2"])
def test_bounded_rerun_matches_pallas(mode):
    """q in the first 32 dims, k in the last 32: every logit is 0 while the
    Cauchy-Schwarz bound is ~1e4 nats, so every p underflows and both
    versions must take the online re-run."""
    q, k, v = _inputs(1, 128, 128, 1, seed=7)
    q[..., 32:] = 0
    k[..., :32] = 0
    q *= 100.0
    k *= 100.0
    (o_j, lse_j), (o_t, lse_t) = _both(q, k, v, None, mode)
    np.testing.assert_allclose(o_t, o_j, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(lse_t, lse_j, atol=ATOL, rtol=RTOL)
    # all logits 0: the exact answer is the mean of v and lse = log(Skv)
    np.testing.assert_allclose(o_t, np.broadcast_to(v.mean(1, keepdims=True), o_t.shape), atol=1e-5)
    np.testing.assert_allclose(lse_t, np.log(128.0), rtol=1e-6)


def test_fully_masked_keys_give_zero_rows():
    q, k, v = _inputs(1, 64, 64, 1, seed=3)
    mask = np.ones(64, bool)
    (o_j, lse_j), (o_t, lse_t) = _both(q, k, v, mask, "online")
    assert np.all(o_t == 0) and np.all(lse_t == -1e30)
    np.testing.assert_allclose(o_t, o_j, atol=ATOL)
    np.testing.assert_allclose(lse_t, lse_j, rtol=1e-6)


@pytest.mark.parametrize(
    "dtype,d,ok",
    [(torch.bfloat16, 64, True), (torch.float32, 64, False), (torch.float16, 64, False), (torch.bfloat16, 128, False)],
)
def test_kernel_input_checks(dtype, d, ok):
    """The CUDA branch's checks read metadata only: run them on meta tensors."""
    q, k, v = (torch.empty(2, s, 3, d, dtype=dtype, device="meta") for s in (40, 50, 50))
    if ok:
        check_kernel_inputs(q, k, v)
    else:
        with pytest.raises(ValueError):
            check_kernel_inputs(q, k, v)


def test_kernel_input_checks_layout():
    q = torch.empty(1, 16, 2, 128, dtype=torch.bfloat16, device="meta")[..., ::2]  # strided last dim
    with pytest.raises(ValueError):
        check_kernel_inputs(q, q, q)
    # aligned strides but a base pointer 2 bytes off a 16-byte boundary
    n = 1 * 16 * 2 * 64
    offset = torch.empty(n + 1, dtype=torch.bfloat16)[1:].view(1, 16, 2, 64)
    aligned = torch.empty(n + 8, dtype=torch.bfloat16)[8:].view(1, 16, 2, 64)
    check_kernel_inputs(aligned, aligned, aligned)
    for args in ((offset, aligned, aligned), (aligned, offset, aligned), (aligned, aligned, offset)):
        with pytest.raises(ValueError, match="16-byte boundary"):
            check_kernel_inputs(*args)
    with pytest.raises(ValueError):
        flash_attention(torch.zeros(1, 8, 1, 64), torch.zeros(1, 8, 1, 64), torch.zeros(1, 9, 1, 64))
    with pytest.raises(ValueError):
        flash_attention(torch.zeros(1, 8, 1, 64), torch.zeros(1, 8, 1, 64), torch.zeros(1, 8, 1, 64),
                        softmax_mode="nope")
