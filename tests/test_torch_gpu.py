"""Kernel B1 on the card against its plain PyTorch version.

Marked ``gpu``; every test skips without a CUDA device (decided inside the
fixture, so every worker collects the same tests).  On a machine with a card:

    python -m pytest tests/test_torch_gpu.py --noconftest -m gpu -q

(``--noconftest``: the repo's conftest configures JAX, which that machine
does not have; this file imports only torch.)
"""

import numpy as np
import pytest
import torch

from s2v_torch.kernels.flash_attention import (
    flash_attention,
    flash_attention_reference,
)

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
