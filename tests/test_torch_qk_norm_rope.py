"""The q/k LayerNorms and RoPE of the joint attention
(``s2v_torch/kernels/qk_norm_rope.py``): on the CPU the wrapper is the plain
chain bit for bit, the emulation of the kernel's arithmetic (fp32
throughout, one rounding) holds to that chain within the repo's bf16/fp16
limits, the metadata check refuses what the kernel does not take, and under
autograd the plain chain runs with its gradients unchanged.  On the card
(marked ``gpu``; they skip without a CUDA device) the kernel is held to the
emulation and to the chain, at small ragged shapes and at the 5b and 2b
shapes.  This file imports only torch, so on the card:

    python -m pytest tests/test_torch_qk_norm_rope.py --noconftest -q
"""

import pytest
import torch

from s2v_torch.kernels import native
from s2v_torch.kernels.qk_norm_rope import (
    check_kernel_inputs,
    qk_norm_rope,
    qk_norm_rope_emulated,
    qk_norm_rope_reference,
)
from s2v_torch.ops.norms import layer_norm
from s2v_torch.ops.rope import apply_rotary_emb, build_segmented_rope, prepare_video_and_ref_rope

# bf16/fp16 against the chain, scaled to the chain's output: max error at
# most 2^-6 of its largest value (a few ulps of it), relative L2 under 1e-2
# (a row left unrotated or unnormalised moves it by far more)
MAX_REL = 2.0 ** -6
L2_REL = 1e-2
EPS = 1e-6
TEXT_LEN = 5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _qk(b, s, h, dtype, device="cpu", seed=0):
    """q and k as the DiT has them: strided views of one fused qkv output,
    with a nonzero mean per row so the centring matters."""
    g = torch.Generator().manual_seed(seed)
    qkv = torch.randn(b, s, 3 * h * 64, generator=g) * 2.0 + torch.randn(b, s, 1, generator=g)
    q, k, _ = qkv.to(device=device, dtype=dtype).chunk(3, dim=-1)
    return q.reshape(b, s, h, 64), k.reshape(b, s, h, 64)


def _norms(dtype, device="cpu", seed=1):
    g = torch.Generator().manual_seed(seed)
    return tuple({"weight": (1.0 + 0.1 * torch.randn(64, generator=g)).to(device=device, dtype=dtype),
                  "bias": (0.02 * torch.randn(64, generator=g)).to(device=device, dtype=dtype)} for _ in range(2))


def _tables(height, width, frames, text_len, device="cpu"):
    """The segmented [text | ref | video] tables the pipeline builds."""
    vc, vs, rc, rs = prepare_video_and_ref_rope(height, width, frames, 64)
    return build_segmented_rope(text_len, rc, rs, vc, vs, device=device)


def _small_tables(device="cpu"):
    return _tables(32, 32, 3, TEXT_LEN, device)  # S = 5 + 4 + 3 * 4 = 21


def _old_chain(q, k, norm_q, norm_k, eps, cos, sin):
    """``joint_attention``'s q/k norm and RoPE before the wrapper."""
    q = layer_norm(q, norm_q["weight"], norm_q["bias"], eps)
    k = layer_norm(k, norm_k["weight"], norm_k["bias"], eps)
    if cos is not None:
        q = apply_rotary_emb(q, cos[:, None, :], sin[:, None, :])
        k = apply_rotary_emb(k, cos[:, None, :], sin[:, None, :])
    return q, k


def _assert_within(got, ref):
    ref = ref.float()
    diff = got.float() - ref
    assert diff.abs().max().item() <= MAX_REL * ref.abs().max().item()
    assert (diff.norm() / ref.norm()).item() < L2_REL


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("rope", [True, False])
def test_wrapper_is_the_plain_chain_on_the_cpu(dtype, rope):
    q, k = _qk(2, 21, 3, dtype)
    assert not q.is_contiguous() and not k.is_contiguous()
    norm_q, norm_k = _norms(dtype)
    cos, sin = _small_tables() if rope else (None, None)
    plain = native.launches("qk_norm_rope_plain")
    got = qk_norm_rope(q, k, norm_q, norm_k, EPS, cos, sin)
    want = _old_chain(q, k, norm_q, norm_k, EPS, cos, sin)
    assert native.launches("qk_norm_rope_plain") == plain + 1
    for g, w in zip(got, want):
        assert g.dtype == dtype and torch.equal(g, w)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("rope", [True, False])
def test_emulation_holds_to_the_plain_chain(dtype, rope):
    q, k = _qk(2, 21, 5, dtype, seed=3)
    norm_q, norm_k = _norms(dtype, seed=4)
    cos, sin = _small_tables() if rope else (None, None)
    got = qk_norm_rope_emulated(q, k, norm_q, norm_k, EPS, cos, sin)
    want = qk_norm_rope_reference(q, k, norm_q, norm_k, EPS, cos, sin)
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == w.shape
        _assert_within(g, w)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_text_rows_take_the_identity_rotation(dtype):
    """The tables' text rows (cos 1, sin 0) leave the normalised rows as
    they are, in the emulation and in the chain, with no special case."""
    q, k = _qk(2, 21, 4, dtype, seed=5)
    norm_q, norm_k = _norms(dtype, seed=6)
    cos, sin = _small_tables()
    assert torch.equal(cos[:TEXT_LEN], torch.ones_like(cos[:TEXT_LEN]))
    for fn in (qk_norm_rope_emulated, qk_norm_rope_reference):
        rotated = fn(q, k, norm_q, norm_k, EPS, cos, sin)
        unrotated = fn(q, k, norm_q, norm_k, EPS)
        for r, u in zip(rotated, unrotated):
            assert torch.equal(r[:, :TEXT_LEN], u[:, :TEXT_LEN])
            assert not torch.equal(r[:, TEXT_LEN:], u[:, TEXT_LEN:])


def _misaligned_rows(q, k, norms, tables):
    wide = torch.zeros(*q.shape[:-1], 65, dtype=q.dtype)[..., :64]  # rows 130 bytes apart
    return wide, k, norms, tables


FAULTS = {
    "float32": lambda q, k, norms, tables: (q.float(), k.float(), norms, tables),
    "head_dim": lambda q, k, norms, tables: (q[..., :32], k[..., :32], norms, tables),
    "row_stride": _misaligned_rows,
    "table_rows": lambda q, k, norms, tables: (q, k, norms, (tables[0][1:], tables[1][1:])),
    "one_table": lambda q, k, norms, tables: (q, k, norms, (tables[0], None)),
    "norm_width": lambda q, k, norms, tables: (q, k, ({"weight": norms[0]["weight"][:32],
                                                        "bias": norms[0]["bias"]}, norms[1]), tables),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_metadata_check_refuses_what_the_kernel_does_not_take(fault):
    q, k = _qk(1, 21, 2, torch.bfloat16)
    norms, tables = _norms(torch.bfloat16), _small_tables()
    check_kernel_inputs(q, k, *norms, *tables)  # the views as the DiT has them pass
    q, k, norms, tables = FAULTS[fault](q, k, norms, tables)
    with pytest.raises(ValueError):
        check_kernel_inputs(q, k, *norms, *tables)


def _grads(fn, dtype, device):
    """(outputs, gradients of q, k's source and the four norm params) of a
    weighted sum of ``fn``'s outputs, everything requiring a gradient."""
    g = torch.Generator().manual_seed(7)
    qkv = (torch.randn(2, 21, 3 * 3 * 64, generator=g) * 2.0).to(device=device, dtype=dtype).requires_grad_()
    q, k, _ = qkv.chunk(3, dim=-1)
    q, k = q.reshape(2, 21, 3, 64), k.reshape(2, 21, 3, 64)
    norm_q, norm_k = _norms(dtype, device)
    params = [t.requires_grad_() for n in (norm_q, norm_k) for t in n.values()]
    cos, sin = _small_tables(device)
    out_q, out_k = fn(q, k, norm_q, norm_k, EPS, cos, sin)
    weights = torch.randn(out_q.shape, generator=g).to(device=device, dtype=dtype)
    loss = (out_q.float() * weights.float()).sum() + (out_k.float() * weights.float().flip(-1)).sum()
    grads = torch.autograd.grad(loss, [qkv, *params])
    return (out_q, out_k), grads


def _autograd_case(device, dtype):
    launches, plain = native.launches("qk_norm_rope"), native.launches("qk_norm_rope_plain")
    outs, grads = _grads(qk_norm_rope, dtype, device)
    assert native.launches("qk_norm_rope") == launches
    assert native.launches("qk_norm_rope_plain") == plain + 1
    want_outs, want_grads = _grads(_old_chain, dtype, device)
    for g, w in zip((*outs, *grads), (*want_outs, *want_grads)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_autograd_runs_the_plain_chain(dtype):
    _autograd_case("cpu", dtype)


# ----------------------------------------------------------------- the card

@pytest.mark.gpu
def test_autograd_runs_the_plain_chain_on_the_card(cuda):
    _autograd_case(cuda, torch.bfloat16)
    q, k = _qk(1, 21, 3, torch.bfloat16, cuda)
    launches, plain = native.launches("qk_norm_rope"), native.launches("qk_norm_rope_plain")
    with torch.no_grad():  # the same call without a gradient takes the kernel
        qk_norm_rope(q.detach().requires_grad_(), k, *_norms(torch.bfloat16, cuda), EPS)
    assert (native.launches("qk_norm_rope"), native.launches("qk_norm_rope_plain")) == (launches + 1, plain)


def _kernel_case(q, k, norm_q, norm_k, cos, sin):
    launches = native.launches("qk_norm_rope")
    got = qk_norm_rope(q, k, norm_q, norm_k, EPS, cos, sin)
    torch.cuda.synchronize()
    assert native.launches("qk_norm_rope") == launches + 1
    emulated = qk_norm_rope_emulated(q, k, norm_q, norm_k, EPS, cos, sin)
    plain = qk_norm_rope_reference(q, k, norm_q, norm_k, EPS, cos, sin)
    for g, e, p in zip(got, emulated, plain):
        assert g.is_contiguous() and g.dtype == q.dtype and g.shape == q.shape
        _assert_within(g, e)
        _assert_within(g, p)


# (B, S, H): heads below and past the kernel's 4-head items (13 leaves one over), ragged tokens
SMALL = [(1, 21, 3), (2, 21, 13), (1, 21, 48)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("rope", [True, False])
@pytest.mark.parametrize("shape", SMALL)
def test_kernel_matches_emulation_and_chain(cuda, dtype, rope, shape):
    q, k = _qk(*shape, dtype, cuda, seed=sum(shape))
    cos, sin = _small_tables(cuda) if rope else (None, None)
    _kernel_case(q, k, *_norms(dtype, cuda), cos, sin)


@pytest.mark.gpu
def test_kernel_takes_fp32_norm_params(cuda):
    """fp32 params are rounded to q's dtype, as the plain chain applies them."""
    q, k = _qk(2, 21, 13, torch.bfloat16, cuda, seed=9)
    _kernel_case(q, k, *_norms(torch.float32, cuda), *_small_tables(cuda))


@pytest.mark.gpu
@pytest.mark.parametrize("model", ["5b", "2b"])
def test_kernel_at_the_main_shapes(cuda, model):
    """5b: bf16 [2, 19126, 48, 64] with the segmented tables of a 49x480x720
    clip; 2b: fp16 [2, 19126, 30, 64] without tables."""
    heads, dtype = (48, torch.bfloat16) if model == "5b" else (30, torch.float16)
    q, k = _qk(2, 19126, heads, dtype, cuda, seed=11)
    cos, sin = _tables(480, 720, 13, 226, cuda) if model == "5b" else (None, None)
    _kernel_case(q, k, *_norms(dtype, cuda), cos, sin)
