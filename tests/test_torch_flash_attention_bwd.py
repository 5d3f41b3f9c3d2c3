"""Kernel B2's plain PyTorch version (what the port runs on CPU tensors)
against the JAX Pallas backward in interpret mode, and the port's
differentiable flash attention (B1 forward, B2 backward) against plain
autograd and against ``jax.vjp`` of the JAX package's ``flash_attention_trainable``."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from s2v_tpu.ops.attention import flash_attention_trainable as j_flash_attention_trainable
from s2v_tpu.ops.pallas import flash_attention as j_fa_mod
from s2v_tpu.ops.pallas import flash_attention_bwd as j_fab_mod
from s2v_torch.kernels.flash_attention import flash_attention
from s2v_torch.kernels.flash_attention_bwd import (
    check_bwd_kernel_inputs,
    flash_attention_bwd,
    flash_attention_bwd_reference,
    row_delta,
)
from s2v_torch.ops.attention import flash_attention_trainable

# fp32 on both sides, P recomputed from the same lse; the same bar as the
# JAX package's own backward test (tests/test_attention_vjp.py)
ATOL, RTOL = 3e-5, 1e-4


def _inputs(b, sq, skv, h, d, seed):
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(b, s, h, d).astype(np.float32) for s in (sq, skv, skv, sq))  # q, k, v, dO


@pytest.mark.parametrize("b,sq,skv,h,d", [(2, 200, 200, 3, 64), (1, 77, 333, 2, 32)], ids=["square", "ragged_sq_ne_skv"])
def test_plain_matches_pallas(b, sq, skv, h, d):
    q, k, v, g = _inputs(b, sq, skv, h, d, seed=sq + skv)
    o, lse = j_fa_mod.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block_q=64, block_k=64,
                                      interpret=True, return_lse=True)
    want = j_fab_mod.flash_attention_bwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), o, lse, jnp.asarray(g),
                                         block_q=64, block_k=64, interpret=True)
    # the lse of the JAX forward goes into the port's backward
    got = flash_attention_bwd(*(torch.from_numpy(np.array(x)) for x in (q, k, v, o, lse, g)))
    for a, w, x in zip(got, want, (q, k, v)):
        assert a.shape == x.shape and a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=ATOL, rtol=RTOL)


def _plain_attention(q, k, v):
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / q.shape[-1] ** 0.5
    return torch.einsum("bhqk,bkhd->bqhd", s.softmax(-1), v)


def test_function_grads_match_autograd_and_jax():
    q, k, v, g = _inputs(1, 200, 200, 2, 64, seed=1)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    o = flash_attention_trainable(*leaves)
    got = torch.autograd.grad(o, leaves, torch.from_numpy(g))
    ref_leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    want = torch.autograd.grad(_plain_attention(*ref_leaves), ref_leaves, torch.from_numpy(g))
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), w.numpy(), atol=ATOL, rtol=RTOL)

    # jax.vjp of the custom VJP, both Pallas kernels in interpret mode
    orig_f, orig_b = j_fa_mod.flash_attention, j_fab_mod.flash_attention_bwd
    try:
        j_fa_mod.flash_attention = lambda q, k, v, **kw: orig_f(q, k, v, block_q=64, block_k=64, interpret=True, **kw)
        j_fab_mod.flash_attention_bwd = lambda *a, **kw: orig_b(*a, block_q=64, block_k=64, interpret=True)
        o_j, vjp = jax.vjp(j_flash_attention_trainable, *(jnp.asarray(x) for x in (q, k, v)))
        want_j = vjp(jnp.asarray(g))
    finally:
        j_fa_mod.flash_attention, j_fab_mod.flash_attention_bwd = orig_f, orig_b
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(o_j), atol=ATOL, rtol=RTOL)
    for a, w in zip(got, want_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=ATOL, rtol=RTOL)


def test_function_without_grad_is_the_forward():
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(1, 70, 90, 2, 64, seed=2))
    want = flash_attention(q, k, v, softmax_mode="bounded")
    assert torch.equal(flash_attention_trainable(q, k, v), want)
    with torch.no_grad():
        assert torch.equal(flash_attention_trainable(*(x.requires_grad_() for x in (q, k, v))), want)


def test_scale_argument():
    q, k, v, g = (torch.from_numpy(x) for x in _inputs(1, 40, 50, 1, 64, seed=3))
    o, lse = flash_attention(q, k, v, scale=0.3, return_lse=True)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    s = torch.einsum("bqhd,bkhd->bhqk", leaves[0], leaves[1]) * 0.3
    want = torch.autograd.grad(torch.einsum("bhqk,bkhd->bqhd", s.softmax(-1), leaves[2]), leaves, g)
    for a, w in zip(flash_attention_bwd_reference(q, k, v, o, lse, g, scale=0.3), want):
        np.testing.assert_allclose(a.numpy(), w.numpy(), atol=ATOL, rtol=RTOL)


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(*shape, dtype=dtype, device="meta")


def test_kernel_input_checks():
    """The CUDA branch's checks read metadata only: run them on meta tensors."""
    q, k, v = _meta(2, 40, 3, 64), _meta(2, 50, 3, 64), _meta(2, 50, 3, 64)
    lse = _meta(2, 3, 40, dtype=torch.float32)
    check_bwd_kernel_inputs(q, k, v, q, lse, q)
    bad = [
        dict(o=_meta(2, 40, 3, 64, dtype=torch.float32)),  # o not bf16
        dict(g=_meta(2, 40, 3, 128)),  # dO with another head dim
        dict(g=_meta(2, 41, 3, 64)),  # dO not q's shape
        dict(lse=_meta(2, 3, 40, dtype=torch.bfloat16)),  # lse not fp32
        dict(lse=_meta(2, 40, 3, dtype=torch.float32)),  # lse not [B, H, Sq]
        dict(lse=_meta(2, 3, 80, dtype=torch.float32)[..., ::2]),  # lse not contiguous
        dict(q=_meta(2, 40, 3, 32), o=_meta(2, 40, 3, 32), g=_meta(2, 40, 3, 32)),  # d != 64
        dict(k=_meta(2, 50, 3, 64, dtype=torch.float16)),
    ]
    for case in bad:
        args = dict(q=q, k=k, v=v, o=q, lse=lse, g=q)
        args.update(case)
        with pytest.raises(ValueError):
            check_bwd_kernel_inputs(**args)


def test_row_delta_and_device_mix():
    o, g = (torch.from_numpy(x) for x in _inputs(2, 30, 30, 3, 64, seed=4)[:2])
    np.testing.assert_allclose(row_delta(o, g).numpy(), (o * g).sum(-1).transpose(1, 2).numpy(), rtol=1e-6)
    assert row_delta(o, g).is_contiguous() and row_delta(o, g).shape == (2, 3, 30)
    q = torch.zeros(1, 8, 1, 64)
    with pytest.raises(ValueError):
        flash_attention_bwd(q, q, q, q, torch.zeros(1, 1, 8, device="meta"), q)
