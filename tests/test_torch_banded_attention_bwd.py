"""Kernel B5's plain PyTorch version (what the port runs on CPU tensors)
against the JAX package's banded backward Pallas kernels in interpret mode
and against ``jax.grad`` of the masked reference, on the geometries of
``test_torch_banded_attention.py``; and the kernels' input checks."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from _torch_parity import BAND_GEOMETRIES as GEOMETRIES
from _torch_parity import band_inputs as inputs
from s2v_tpu.ops.pallas.banded_attention import banded_flash_attention as j_banded_flash_attention
from s2v_tpu.ops.pallas.banded_attention_bwd import banded_flash_attention_bwd as j_banded_flash_attention_bwd
from s2v_tpu.ops.windowed_attention import windowed_attention_reference as j_windowed_reference
from s2v_torch.kernels.banded_attention_bwd import (
    banded_flash_attention_bwd,
    banded_flash_attention_bwd_reference,
    check_banded_bwd_kernel_inputs,
)
from s2v_torch.kernels.flash_attention_bwd import row_delta

# fp32 on both sides, P recomputed from the same lse; grads are O(1), and the
# two sides differ only by the order of fp32 sums and where the scale goes
ATOL, RTOL = 1e-5, 1e-5


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_plain_matches_pallas_and_autodiff(geometry):
    b, h, g, tpf, f, w = GEOMETRIES[geometry]
    q, k, v, ct = inputs(b, h, g, tpf, f, seed=sum(GEOMETRIES[geometry]) + 1)
    jq, jk, jv, jct = (jnp.asarray(x) for x in (q, k, v, ct))
    o, lse = j_banded_flash_attention(jq, jk, jv, g, tpf, w, interpret=True, return_lse=True)
    want = j_banded_flash_attention_bwd(jq, jk, jv, o, lse, jct, g, tpf, w, interpret=True)
    # the JAX forward's o and lse go into the port's backward
    got = banded_flash_attention_bwd(*(torch.from_numpy(np.array(x)) for x in (q, k, v, o, lse, ct)), g, tpf, w)
    autodiff = jax.grad(lambda q_, k_, v_: jnp.sum(j_windowed_reference(q_, k_, v_, g, tpf, w) * jct),
                        argnums=(0, 1, 2))(jq, jk, jv)
    for a, x, y, z in zip(got, want, autodiff, (q, k, v)):
        assert a.shape == z.shape and a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(x), atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(a.numpy(), np.asarray(y), atol=ATOL, rtol=RTOL)


def test_scale_argument():
    """An explicit softmax scale against autograd of the plain masked softmax."""
    from s2v_torch.kernels.banded_attention import band_geometry, band_mask, banded_flash_attention

    q, k, v, ct = (torch.from_numpy(x) for x in inputs(1, 2, 24, 20, 5, seed=9))
    o, lse = banded_flash_attention(q, k, v, 24, 20, 1, scale=0.3, return_lse=True)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    mask = band_mask(band_geometry(124, 24, 20, 1), torch.arange(124), 124)
    s = (torch.einsum("bqhd,bkhd->bhqk", leaves[0], leaves[1]) * 0.3).masked_fill(~mask, float("-inf"))
    want = torch.autograd.grad(torch.einsum("bhqk,bkhd->bqhd", s.softmax(-1), leaves[2]), leaves, ct)
    for a, x in zip(banded_flash_attention_bwd_reference(q, k, v, o, lse, ct, 24, 20, 1, scale=0.3), want):
        np.testing.assert_allclose(a.numpy(), x.numpy(), atol=ATOL, rtol=RTOL)


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(*shape, dtype=dtype, device="meta")


def test_kernel_input_checks():
    """The CUDA branch's checks read metadata only: run them on meta tensors."""
    x = _meta(2, 124, 3, 64)
    lse = _meta(2, 3, 124, dtype=torch.float32)
    check_banded_bwd_kernel_inputs(x, x, x, x, lse, x)
    bad = [
        dict(o=_meta(2, 124, 3, 64, dtype=torch.float32)),  # o not bf16
        dict(g=_meta(2, 124, 3, 32)),  # dO with another head dim
        dict(g=_meta(2, 123, 3, 64)),  # dO not q's shape
        dict(k=_meta(2, 124, 3, 64, dtype=torch.float16)),
        dict(lse=_meta(2, 3, 124, dtype=torch.bfloat16)),  # lse not fp32
        dict(lse=_meta(2, 124, 3, dtype=torch.float32)),  # lse not [B, H, S]
        dict(lse=_meta(2, 3, 248, dtype=torch.float32)[..., ::2]),  # lse not contiguous
    ]
    for case in bad:
        args = dict(q=x, k=x, v=x, o=x, lse=lse, g=x)
        args.update(case)
        with pytest.raises(ValueError):
            check_banded_bwd_kernel_inputs(**args)


def test_bad_inputs_raise():
    q = torch.zeros(1, 124, 1, 64)
    lse = torch.zeros(1, 1, 124)
    with pytest.raises(ValueError):
        banded_flash_attention_bwd(q, q, q, q, lse, q, 24, 21, 1)  # ragged video segment
    with pytest.raises(ValueError):
        banded_flash_attention_bwd(q, q, q, q, lse[..., :-1], q, 24, 20, 1)  # lse not [B, H, S]
    with pytest.raises(ValueError):
        banded_flash_attention_bwd(q, q, q, q, lse.to("meta"), q, 24, 20, 1)  # devices mixed
    np.testing.assert_allclose(row_delta(q + 1, q + 2).numpy(), np.full((1, 1, 124), 128.0))
