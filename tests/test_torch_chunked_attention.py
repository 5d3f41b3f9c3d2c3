"""The ``chunked`` attention backend against the JAX package's
``chunked_attention`` and against the plain attention: the forward and the
autograd gradients, at sequence lengths that are not a multiple of the
query block."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from _torch_parity import rand, t
from s2v_tpu.ops.attention import chunked_attention as j_chunked_attention
from s2v_torch.kernels.flash_attention import flash_attention_reference
from s2v_torch.ops.attention import chunked_attention

# fp32 softmax attention over at most 130 keys, outputs and grads O(1)
ATOL, RTOL = 2e-5, 1e-5


def _qkv(b, s, h, d, seed):
    return tuple(rand(b, s, h, d, seed=seed + i) for i in range(4))


@pytest.mark.parametrize("b,s,h,d,block_q", [(2, 77, 3, 16, 32), (1, 130, 2, 8, 64), (1, 20, 2, 16, 1024)])
def test_forward_and_grads_match_jax_and_plain(b, s, h, d, block_q):
    q, k, v, do = _qkv(b, s, h, d, seed=s)
    want = j_chunked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block_q=block_q)
    jgrads = jax.grad(lambda q_, k_, v_: jnp.sum(j_chunked_attention(q_, k_, v_, block_q=block_q) * do),
                      argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))

    tq, tk, tv = (t(a).requires_grad_(True) for a in (q, k, v))
    got = chunked_attention(tq, tk, tv, block_q=block_q)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)
    grads = torch.autograd.grad(got, (tq, tk, tv), t(do))
    for g, w in zip(grads, jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=RTOL)

    pq, pk, pv = (t(a).requires_grad_(True) for a in (q, k, v))
    plain = flash_attention_reference(pq, pk, pv)
    np.testing.assert_allclose(got.detach().numpy(), plain.detach().numpy(), atol=ATOL, rtol=RTOL)
    for g, w in zip(grads, torch.autograd.grad(plain, (pq, pk, pv), t(do))):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=ATOL, rtol=RTOL)


def test_backward_keeps_no_probabilities():
    """Under autograd each query block runs in ``torch.utils.checkpoint``:
    the graph keeps the inputs, not one block's [B, H, block, S] fp32
    probabilities."""
    b, s, h, d = 1, 300, 2, 8
    q, k, v, _ = (t(a).requires_grad_(True) for a in _qkv(b, s, h, d, seed=1))
    saved = []

    def pack(x):
        saved.append(x.numel())
        return x

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda x: x):
        out = chunked_attention(q, k, v, block_q=64)
    assert saved and max(saved) <= b * s * h * d  # no tensor of 64 x 300 logits per head
    out.sum().backward()
    assert all(x.grad is not None and torch.isfinite(x.grad).all() for x in (q, k, v))


def test_without_autograd_it_is_the_same_function():
    q, k, v, _ = (t(a) for a in _qkv(1, 50, 2, 8, seed=3))
    with torch.no_grad():
        a = chunked_attention(q, k, v, block_q=16)
    b = chunked_attention(q.requires_grad_(True), k, v, block_q=16)
    assert torch.equal(a, b.detach())
