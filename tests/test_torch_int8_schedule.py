"""Kernel B3's schedule, emulated in PyTorch
(``flash_attention_qk_int8_blocked``: 128-row query tiles walking 128-key
tiles, int32-exact logits, an online softmax in exp2 with the ragged key
tail at -inf, P rounded to bf16 before P·V), against the plain version and
the JAX Pallas kernel in interpret mode on the same numpy inputs: ragged
Sq and Skv (54 mod 128, as at the main shape), Sq != Skv both ways, a
single key tile, negative-logit rows with a ragged tail, and CFG halves of
different magnitudes.  Also the pre-pass's rounding rules against JAX's
``_quantize_tensor``, bit for bit.  The card holds the kernels to the same
emulation and the pre-pass kernels to the plain pre-pass
(tests/test_torch_gpu.py, chip_smoke.py)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from _torch_parity import t
from s2v_tpu.ops.pallas import int8_attention as j_int8
from s2v_torch.kernels.int8_attention import (
    flash_attention_qk_int8_blocked,
    flash_attention_qk_int8_reference,
    int8_prepass,
    quantize_tensor_int8,
)

# fp32 inputs; the emulation rounds P to bf16 before P·V (relative 2^-9, the
# plain version and the JAX kernel on fp32 inputs keep it fp32), so it is
# held to the card's limits for a kernel against its plain version: max
# error at most 2^-6 of the largest output element, relative L2 below 1e-2.
# A dropped or repeated key tile moves the relative L2 by several percent.
MAX_REL, L2_REL = 2.0 ** -6, 1e-2


def _assert_close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    diff = got - want
    assert np.abs(diff).max() <= MAX_REL * np.abs(want).max()
    assert np.linalg.norm(diff) / np.linalg.norm(want) < L2_REL


def _inputs(name):
    """(q, k, v) in fp32 numpy, [B, S, H, 64]."""
    geometry = {"ragged_54": (2, 182, 182, 2), "sq_lt_skv": (1, 77, 310, 2), "sq_gt_skv": (1, 310, 182, 2),
                "single_key_tile": (1, 200, 100, 3), "negative_logits": (1, 70, 182, 1), "halves": (2, 150, 182, 2)}
    b, sq, skv, h = geometry[name]
    rng = np.random.RandomState(sq * 3 + skv)
    q, k, v = (rng.randn(b, s, h, 64).astype(np.float32) for s in (sq, skv, skv))
    if name == "negative_logits":
        # every real scaled logit about -128, 54 keys in the last tile: a
        # zero pad key taken as logit 0 would pin the max and zero the row
        q = np.full_like(q, 4.0)
        k = -4.0 + 0.01 * k
    elif name == "halves":
        q[1] *= 3.0
        k[1] *= 0.25
    return q, k, v


def _jax_int8(q, k, v):
    return np.asarray(j_int8.flash_attention_qk_int8(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block_q=64,
                                                     block_k=128, interpret=True))


CASES = ["ragged_54", "sq_lt_skv", "sq_gt_skv", "single_key_tile", "negative_logits", "halves"]


@pytest.mark.parametrize("name", CASES)
def test_blocked_schedule_matches_plain_and_pallas(name):
    q, k, v = _inputs(name)
    got = flash_attention_qk_int8_blocked(t(q), t(k), t(v))
    assert got.shape == q.shape and got.dtype == torch.float32
    assert np.isfinite(got.numpy()).all()
    _assert_close(got.numpy(), flash_attention_qk_int8_reference(t(q), t(k), t(v)).numpy())
    _assert_close(got.numpy(), _jax_int8(q, k, v))
    if name == "negative_logits":
        assert np.abs(got.numpy()).max() > 0.01  # not the all-zero failure


def test_blocked_schedule_rounds_p_to_bf16():
    """The emulation is the kernel's arithmetic, not the plain version's:
    P rounded to bf16 moves the output by more than fp32 noise; and on bf16
    inputs it returns bf16 within the limits of the plain version's."""
    q, k, v = _inputs("ragged_54")
    got = flash_attention_qk_int8_blocked(t(q), t(k), t(v)).numpy()
    plain = flash_attention_qk_int8_reference(t(q), t(k), t(v)).numpy()
    assert np.abs(got - plain).max() > 1e-5
    bf16 = [t(x).to(torch.bfloat16) for x in (q, k, v)]
    got = flash_attention_qk_int8_blocked(*bf16)
    assert got.dtype == torch.bfloat16
    _assert_close(got.float().numpy(), flash_attention_qk_int8_reference(*bf16).float().numpy())


_jax_quantize = jax.jit(j_int8._quantize_tensor)  # jitted, as inside the JAX wrapper


def _assert_quantize_equals_jax(x):
    """``quantize_tensor_int8`` of a torch tensor against JAX's
    ``_quantize_tensor`` of the same values, bit for bit."""
    got, scale = quantize_tensor_int8(x)
    x_jax = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16) if x.dtype == torch.bfloat16 else jnp.asarray(x)
    want, want_scale = _jax_quantize(x_jax)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert scale.dtype == torch.float32 and scale.item() == float(want_scale)
    return got


@pytest.mark.parametrize("e", [-3, 0, 2])
def test_quantize_rounds_ties_half_to_even(e):
    """With amax = 127·2^e the scale is 2^e exactly, so (n + 0.5)·2^e
    divides to an exact .5 and rounds half to even, as in JAX."""
    n = np.arange(-127, 127, dtype=np.float32)
    x = np.concatenate([(n + 0.5) * 2.0 ** e, [127 * 2.0 ** e]]).astype(np.float32)
    got = _assert_quantize_equals_jax(t(x)).numpy()
    np.testing.assert_array_equal(got[:-1], np.rint(n + 0.5).astype(np.int8))
    assert got[-1] == 127


def test_quantize_all_zero_tensor_has_scale_one():
    got, scale = quantize_tensor_int8(torch.zeros(3, 64))
    assert scale.item() == 1.0 and not got.any()
    _assert_quantize_equals_jax(torch.zeros(3, 64))


def test_quantize_clamps_to_127_and_never_gives_minus_128():
    """The amax maps to ±127 (the scale multiplies by fp32(1/127), so the
    quotient may land just above 127 before rounding), never -128."""
    rng = np.random.RandomState(5)
    for amax in (1.0, 3.0, 1e-3, 7.25):
        x = rng.uniform(-amax, amax, 500).astype(np.float32)
        x[:2] = (amax, -amax)
        got = _assert_quantize_equals_jax(t(x)).numpy()
        assert got[0] == 127 and got[1] == -127 and got.min() >= -127


def test_bf16_prepass_equals_jax():
    """bf16 q and k quantize in fp32, as JAX's ``x.astype(float32) / scale``
    (a bf16 division would round the quotient to bf16 and move about one
    value in twenty by one int8 step)."""
    rng = np.random.RandomState(6)
    q, k = (torch.from_numpy(rng.randn(2, 90, 2, 64).astype(np.float32)).to(torch.bfloat16) for _ in range(2))
    _assert_quantize_equals_jax(k)
    q_i8, k_i8, dq = int8_prepass(q, k, 0.125)
    fold = lambda x: x.transpose(0, 2, 1, 3).reshape(-1, x.shape[1], x.shape[3])  # noqa: E731

    @jax.jit
    def prepass(q, k):
        jq, qs = j_int8._quantize_tensor(fold(q) * jnp.asarray(0.125, jnp.float32))
        jk, ks = j_int8._quantize_tensor(fold(k))
        return jq, jk, qs * ks

    jq, jk, jdq = prepass(*(jnp.asarray(x.float().numpy()).astype(jnp.bfloat16) for x in (q, k)))
    np.testing.assert_array_equal(q_i8.transpose(1, 2).reshape(-1, 90, 64).numpy(), np.asarray(jq))
    np.testing.assert_array_equal(k_i8.transpose(1, 2).reshape(-1, 90, 64).numpy(), np.asarray(jk))
    assert dq.item() == float(jdq)
