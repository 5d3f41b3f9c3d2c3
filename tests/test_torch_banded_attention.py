"""Kernel B4's plain PyTorch version (what the port runs on CPU tensors)
against the JAX package's banded Pallas kernel in interpret mode and its
masked reference; the port's differentiable banded attention (B4 forward,
B5 backward) against ``jax.vjp`` of the JAX package's
``banded_attention_trainable``; the band's geometry and the kernels' input
checks.  The same numpy inputs go into both packages, in fp32."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from _torch_parity import BAND_GEOMETRIES as GEOMETRIES
from _torch_parity import band_inputs as inputs
from s2v_tpu.ops.attention import banded_attention_trainable as j_banded_attention_trainable
from s2v_tpu.ops.pallas.banded_attention import banded_flash_attention as j_banded_flash_attention
from s2v_tpu.ops.windowed_attention import windowed_attention_reference as j_windowed_reference
from s2v_torch.kernels.banded_attention import (
    band_geometry,
    band_mask,
    banded_flash_attention,
    banded_flash_attention_reference,
    check_banded_kernel_inputs,
)
from s2v_torch.kernels.flash_attention import flash_attention_reference
from s2v_torch.ops.attention import banded_attention_trainable

# fp32 on both sides; outputs and lse are O(1), and the JAX kernel (interpret
# mode) and the plain version differ only by the order of fp32 sums and by
# where the softmax scale is applied (q before the product there, the logits
# after it here): ~5e-7 in practice
ATOL, RTOL = 1e-5, 1e-5


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_plain_matches_pallas_and_masked_reference(geometry):
    b, h, g, tpf, f, w = GEOMETRIES[geometry]
    q, k, v = inputs(b, h, g, tpf, f, seed=sum(GEOMETRIES[geometry]), n=3)
    o_j, lse_j = j_banded_flash_attention(*(jnp.asarray(x) for x in (q, k, v)), g, tpf, w, interpret=True,
                                          return_lse=True)
    o, lse = banded_flash_attention(*(torch.from_numpy(x) for x in (q, k, v)), g, tpf, w, return_lse=True)
    assert o.shape == q.shape and lse.shape == (b, h, q.shape[1]) and o.dtype == torch.float32
    np.testing.assert_allclose(o.numpy(), np.asarray(o_j), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j), atol=ATOL, rtol=RTOL)
    ref = j_windowed_reference(*(jnp.asarray(x) for x in (q, k, v)), g, tpf, w)
    np.testing.assert_allclose(o.numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)
    if 2 * w + 1 >= f:  # the window covers the clip: exact attention
        exact = flash_attention_reference(*(torch.from_numpy(x) for x in (q, k, v)))
        np.testing.assert_allclose(o.numpy(), exact.numpy(), atol=ATOL, rtol=RTOL)


def test_trainable_grads_match_jax_vjp():
    b, h, g, tpf, f, w = GEOMETRIES["tpf_20_clamped_w1"]
    q, k, v, ct = inputs(b, h, g, tpf, f, seed=5)
    o_j, vjp = jax.vjp(lambda q_, k_, v_: j_banded_attention_trainable(q_, k_, v_, g, tpf, w, True),
                       *(jnp.asarray(x) for x in (q, k, v)))
    want = vjp(jnp.asarray(ct))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    o = banded_attention_trainable(*leaves, g, tpf, w)
    got = torch.autograd.grad(o, leaves, torch.from_numpy(ct))
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(o_j), atol=ATOL, rtol=RTOL)
    for a, x in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(x), atol=ATOL, rtol=RTOL)


def test_trainable_without_grad_is_the_forward():
    q, k, v = (torch.from_numpy(x) for x in inputs(1, 2, 24, 20, 5, seed=6, n=3))
    want = banded_flash_attention(q, k, v, 24, 20, 1)
    assert torch.equal(banded_attention_trainable(q, k, v, 24, 20, 1), want)
    with torch.no_grad():
        assert torch.equal(banded_attention_trainable(*(x.requires_grad_() for x in (q, k, v)), 24, 20, 1), want)


@pytest.mark.parametrize("f,w", [(1, 0), (2, 0), (3, 1), (4, 1), (5, 1), (6, 2), (13, 2), (7, 3), (5, 9), (40, 2)])
def test_geometry_window_and_inverse_band(f, w):
    """ws(f), the inverse band's closed form (which kernel B5 computes on the
    device) against its definition, and the mask against both."""
    g, tpf = 3, 2
    geo = band_geometry(g + f * tpf, g, tpf, w)
    assert (geo.n_frames, geo.span) == (f, min(2 * w + 1, f))
    mask = band_mask(geo, torch.arange(g + f * tpf), g + f * tpf)
    assert mask[:g].all() and mask[:, :g].all()
    for fq in range(f):
        ws = geo.window_start(fq)
        assert 0 <= ws <= fq <= ws + geo.span - 1 < f
        row = mask[g + fq * tpf, g:].reshape(f, tpf)
        assert row.all(1).tolist() == [ws <= fk < ws + geo.span for fk in range(f)]
    for fk in range(f):
        queries = [fq for fq in range(f) if geo.window_start(fq) <= fk < geo.window_start(fq) + geo.span]
        assert queries == list(range(queries[0], queries[-1] + 1))  # contiguous
        assert geo.inverse_band(fk) == (queries[0], queries[-1])
    pairs_vid, pairs_glob = geo.pairs()
    assert pairs_vid == int(mask[g:].sum()) and pairs_glob == int(mask[:g].sum())


def test_bad_geometry_raises():
    q = torch.zeros(1, 24 + 5 * 20, 2, 16)
    with pytest.raises(ValueError):
        banded_flash_attention(q, q, q, 0, 20, 1)  # no global segment
    with pytest.raises(ValueError):
        banded_flash_attention(q, q, q, 24, 21, 1)  # ragged video segment
    with pytest.raises(ValueError):
        banded_flash_attention(q, q, q, 24, 20, -1)
    with pytest.raises(ValueError):
        banded_flash_attention(q, q[:, 1:], q[:, 1:], 24, 20, 1)


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(*shape, dtype=dtype, device="meta")


def test_kernel_input_checks():
    """The CUDA branch's checks read metadata only: run them on meta tensors."""
    x = _meta(2, 124, 3, 64)
    check_banded_kernel_inputs(x, x, x)
    for bad in (_meta(2, 124, 3, 64, dtype=torch.float32), _meta(2, 124, 3, 32),
                _meta(2, 124, 3, 128)[..., ::2], _meta(2, 124, 3, 64, dtype=torch.float16)):
        with pytest.raises(ValueError):
            check_banded_kernel_inputs(x, bad, x)


def test_device_mix_raises():
    q = torch.zeros(1, 44, 1, 64)
    with pytest.raises(ValueError):
        banded_flash_attention(q, q, q.to("meta"), 24, 10, 1)


def test_reference_chunks_agree():
    """The plain version's query chunks (512 rows) stitch to one softmax:
    a sequence longer than a chunk against the masked reference."""
    q, k, v = (torch.from_numpy(x) for x in inputs(1, 1, 40, 130, 5, seed=7, n=3))
    got = banded_flash_attention_reference(q, k, v, 40, 130, 1)
    want = j_windowed_reference(*(jnp.asarray(x.numpy()) for x in (q, k, v)), 40, 130, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)
