"""The adaLN-Zero LayerNorms, modulation and stream join
(``s2v_torch/kernels/adaln.py``): on the CPU the wrapper is the plain chain
bit for bit (in bf16, fp16 and fp32, and under autograd), the emulation of
the kernel's arithmetic (fp32 throughout, one rounding) holds to that chain
within the repo's bf16/fp16 limits in the merged and disentangled modes,
the joined rows are laid out ``[text | ref | video]`` with each stream's
modulation, and the metadata check refuses what the kernel does not take.
On the card (marked ``gpu``; they skip without a CUDA device) the kernel is
held to the emulation (one ulp) and to the chain, at small ragged shapes, on
strided streams, and at the 5b, 2b and 1.5 shapes.  This file imports only
torch, so on the card:

    python -m pytest tests/test_torch_adaln_kernel.py --noconftest -q
"""

import pytest
import torch

from s2v_torch.kernels import native
from s2v_torch.kernels.adaln import (
    adaln_zero_join,
    adaln_zero_join_emulated,
    adaln_zero_join_reference,
    check_kernel_inputs,
    ulps_from_emulation,
)
from s2v_torch.ops.adaln import ada_layer_norm_out, ada_layer_norm_zero_3stream, ada_layer_norm_zero_joined

# bf16/fp16 against the chain, scaled to the chain's output: max error at
# most 2^-6 of its largest value (a few ulps of it), relative L2 under 1e-2
# (a row left unnormalised or modulated by another stream's rows moves it
# by far more)
MAX_REL = 2.0 ** -6
L2_REL = 1e-2
EPS = 1e-5
TEMB = 16  # the time embedding's width in these tests


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _streams(b, lens, d, dtype, device="cpu", seed=0):
    """text, ref and video ``[B, L, D]`` as the blocks have them: the rows
    of a residual stream, each with its own mean, so the centring matters."""
    g = torch.Generator().manual_seed(seed)
    return tuple((torch.randn(b, n, d, generator=g) * 2.0 + torch.randn(b, n, 1, generator=g))
                 .to(device=device, dtype=dtype) for n in lens)


def _params(d, dtype, device="cpu", seed=1, chunks=6, base=False):
    """An adaLN params dict: the modulation linear ``[chunks * D, TEMB]`` in
    fp32, the norm's ``[D]`` weight and bias in ``dtype``; with ``base`` a
    second linear for the disentangled mode."""
    g = torch.Generator().manual_seed(seed)

    def linear():
        return {"weight": (0.3 * torch.randn(chunks * d, TEMB, generator=g)).to(device),
                "bias": (0.1 * torch.randn(chunks * d, generator=g)).to(device)}

    params = {"linear": linear(),
              "norm": {"weight": (1.0 + 0.1 * torch.randn(d, generator=g)).to(device=device, dtype=dtype),
                       "bias": (0.05 * torch.randn(d, generator=g)).to(device=device, dtype=dtype)}}
    return (params, linear()) if base else (params, None)


def _temb(b, dtype, device="cpu", seed=2):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(b, TEMB, generator=g).to(device=device, dtype=dtype)


def _mods(b, d, device="cpu", n=3, seed=3):
    """(shift, scale) fp32 ``[B, D]`` views of one ``[B, 2n D]`` tensor."""
    g = torch.Generator().manual_seed(seed)
    chunks = (0.5 * torch.randn(b, 2 * n * d, generator=g)).to(device).chunk(2 * n, dim=-1)
    return [(chunks[2 * i], chunks[2 * i + 1]) for i in range(n)]


def _old_block_join(params, video, text, ref, temb, base):
    """``block_forward``'s modulation before the wrapper: the three plain
    streams and a ``torch.cat``."""
    v_n, t_n, r_n, *gates = ada_layer_norm_zero_3stream(params, video, text, ref, temb, EPS, base_linear=base)
    return torch.cat([t_n, r_n, v_n], dim=1), tuple(gates)


def _assert_within(got, ref):
    ref = ref.float()
    diff = got.float() - ref
    assert diff.abs().max().item() <= MAX_REL * ref.abs().max().item()
    assert (diff.norm() / ref.norm()).item() < L2_REL


# -------------------------------------------------------------- the CPU

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
@pytest.mark.parametrize("base", [False, True])
def test_wrapper_is_the_plain_chain_on_the_cpu(dtype, base):
    text, ref, video = _streams(2, (5, 7, 12), 64, dtype)
    params, base_linear = _params(64, dtype, base=base)
    temb = _temb(2, dtype)
    plain, launches = native.launches("adaln_zero_join_plain"), native.launches("adaln_zero_join")
    joined, gates = ada_layer_norm_zero_joined(params, video, text, ref, temb, EPS, base_linear=base_linear)
    assert (native.launches("adaln_zero_join_plain"), native.launches("adaln_zero_join")) == (plain + 1, launches)
    want, want_gates = _old_block_join(params, video, text, ref, temb, base_linear)
    assert joined.dtype == dtype and torch.equal(joined, want)
    for g, w in zip(gates, want_gates):
        assert torch.equal(g, w)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_norm_out_is_the_plain_chain_on_the_cpu(dtype):
    """The output AdaLayerNorm: one stream, (shift, scale) from a [B, 2D]
    modulation, the stream's strided view as the DiT hands it over."""
    joint = _streams(2, (19,), 64, dtype, seed=4)[0]
    video = joint[:, 5:]
    params, _ = _params(64, dtype, seed=5, chunks=2)
    temb = _temb(2, dtype)
    plain = native.launches("adaln_zero_join_plain")
    got = ada_layer_norm_out(params, video, temb, EPS)
    assert native.launches("adaln_zero_join_plain") == plain + 1
    shift, scale = torch.nn.functional.linear(torch.nn.functional.silu(temb.float()), params["linear"]["weight"],
                                              params["linear"]["bias"]).chunk(2, dim=-1)
    from s2v_torch.ops.norms import layer_norm

    want = layer_norm(video, params["norm"]["weight"], params["norm"]["bias"], EPS)
    want = want * (1.0 + scale[:, None, :]).to(dtype) + shift[:, None, :].to(dtype)
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("base", [False, True])
@pytest.mark.parametrize("lens", [(5, 7, 12), (9, 0, 21)], ids=["s2v", "t2v"])
def test_emulation_holds_to_the_plain_chain(dtype, base, lens):
    """Merged and disentangled modulation, with a ref and with a zero-width
    one (T2V)."""
    text, ref, video = _streams(2, lens, 96, dtype, seed=6)
    params, base_linear = _params(96, dtype, seed=7, base=base)
    temb = _temb(2, dtype)
    want, _ = _old_block_join(params, video, text, ref, temb, base_linear)
    from s2v_torch.ops.adaln import _stream_modulations

    (v_mod, t_mod, r_mod), _ = _stream_modulations(params, temb, base_linear, None)
    got = adaln_zero_join_emulated((text, ref, video), (t_mod, r_mod, v_mod), params["norm"], EPS)
    assert got.dtype == dtype and got.shape == want.shape == (2, sum(lens), 96)
    _assert_within(got, want)


@pytest.mark.parametrize("fn", [adaln_zero_join_reference, adaln_zero_join_emulated])
def test_joined_rows_are_text_ref_video_with_their_own_modulation(fn):
    """Each stream lands at its place in ``[text | ref | video]``, and each
    place holds its own stream's (shift, scale): with the norm the identity,
    a stream of constant rows normalises to 0, so its rows read its shift."""
    d, lens = 32, (3, 4, 6)
    streams = tuple(torch.full((2, n, d), float(i + 1)) for i, n in enumerate(lens))
    mods = [(torch.full((2, d), 10.0 * (i + 1)) + torch.arange(2.0)[:, None], torch.randn(2, d)) for i in range(3)]
    norm = {"weight": torch.ones(d), "bias": torch.zeros(d)}
    joined = fn(streams, mods, norm, EPS)
    starts = (0, 3, 7, 13)
    for i in range(3):
        rows = joined[:, starts[i]:starts[i + 1]]
        assert torch.equal(rows, mods[i][0][:, None, :].expand_as(rows))


def _grads(fn, dtype):
    """(output, gradients of the three streams, the modulation and the norm
    params) of a weighted sum of ``fn``'s joined output."""
    text, ref, video = (t.requires_grad_() for t in _streams(2, (5, 7, 12), 64, dtype, seed=8))
    mod = (0.5 * torch.randn(2, 6 * 64, generator=torch.Generator().manual_seed(9))).requires_grad_()
    chunks = mod.chunk(6, dim=-1)
    mods = [(chunks[3], chunks[4]), (chunks[0], chunks[1]), (chunks[0], chunks[1])]
    norm = {key: t.requires_grad_() for key, t in _params(64, dtype, seed=10)[0]["norm"].items()}
    out = fn((text, ref, video), mods, norm, EPS)
    weights = torch.randn(out.shape, generator=torch.Generator().manual_seed(11))
    loss = (out.float() * weights).sum()
    return out, torch.autograd.grad(loss, [text, ref, video, mod, norm["weight"], norm["bias"]])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_autograd_runs_the_plain_chain(dtype):
    launches, plain = native.launches("adaln_zero_join"), native.launches("adaln_zero_join_plain")
    out, grads = _grads(adaln_zero_join, dtype)
    assert native.launches("adaln_zero_join") == launches
    assert native.launches("adaln_zero_join_plain") == plain + 1
    want_out, want_grads = _grads(adaln_zero_join_reference, dtype)
    for g, w in zip((out, *grads), (want_out, *want_grads)):
        assert torch.equal(g, w)


def _misaligned_rows(streams, mods, norm):
    wide = torch.zeros(2, 4, 65, dtype=torch.bfloat16)[..., :64]  # rows 130 bytes apart
    return (streams[0], wide, streams[2]), mods, norm


def _misaligned_shift(streams, mods, norm):
    shifted = torch.zeros(2 * 64 + 1)[1:].view(2, 64)  # starts 4 bytes into its storage
    return streams, [(shifted, mods[0][1]), *mods[1:]], norm


FAULTS = {
    "width_not_8": lambda s, m, n: (tuple(x[..., :60] for x in s), [(a[:, :60], b[:, :60]) for a, b in m],
                                    {k: v[:60] for k, v in n.items()}),
    "width_over_limit": lambda s, m, n: (tuple(torch.zeros(2, x.shape[1], 4104, dtype=x.dtype) for x in s),
                                         [(torch.zeros(2, 4104),) * 2] * 3,
                                         {k: torch.zeros(4104, dtype=v.dtype) for k, v in n.items()}),
    "float32": lambda s, m, n: (tuple(x.float() for x in s), m, {k: v.float() for k, v in n.items()}),
    "mixed_dtype": lambda s, m, n: ((s[0], s[1].half(), s[2]), m, n),
    "batch": lambda s, m, n: ((s[0][:1], s[1], s[2]), m, n),
    "stream_width": lambda s, m, n: ((s[0][..., :32], s[1], s[2]), m, n),
    "shift_rows": lambda s, m, n: (s, [(m[0][0][:1], m[0][1]), *m[1:]], n),
    "scale_dtype": lambda s, m, n: (s, [(m[0][0], m[0][1].to(torch.bfloat16)), *m[1:]], n),
    "norm_width": lambda s, m, n: (s, m, {"weight": n["weight"][:32], "bias": n["bias"]}),
    "row_stride": _misaligned_rows,
    "shift_offset": _misaligned_shift,
    "four_streams": lambda s, m, n: ((*s, s[2]), [*m, m[2]], n),
    "no_modulation": lambda s, m, n: (s, m[:2], n),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_metadata_check_refuses_what_the_kernel_does_not_take(fault):
    streams = _streams(2, (5, 4, 12), 64, torch.bfloat16)
    mods = _mods(2, 64)
    norm = _params(64, torch.bfloat16)[0]["norm"]
    check_kernel_inputs(streams, mods, norm)  # the views as the DiT has them pass
    check_kernel_inputs((streams[2][:, 3:],), mods[:1], norm)  # norm_out's strided video rows pass
    with pytest.raises(ValueError):
        check_kernel_inputs(*FAULTS[fault](streams, mods, norm))


# ----------------------------------------------------------------- the card

def _assert_within_ulp(got, emulated):
    """At most one unit in the last place from the emulation (the kernel
    sums in another order and fuses multiply-adds)."""
    assert ulps_from_emulation(got, emulated) <= 1


def _kernel_case(streams, mods, norm):
    launches, plain = native.launches("adaln_zero_join"), native.launches("adaln_zero_join_plain")
    got = adaln_zero_join(streams, mods, norm, EPS)
    torch.cuda.synchronize()
    assert (native.launches("adaln_zero_join"), native.launches("adaln_zero_join_plain")) == (launches + 1, plain)
    emulated = adaln_zero_join_emulated(streams, mods, norm, EPS)
    assert got.is_contiguous() and got.dtype == streams[0].dtype and got.shape == emulated.shape
    _assert_within_ulp(got, emulated)
    _assert_within(got, adaln_zero_join_reference(streams, mods, norm, EPS))


@pytest.mark.gpu
def test_autograd_runs_the_plain_chain_on_the_card(cuda):
    text, ref, video = (t.requires_grad_() for t in _streams(2, (5, 7, 12), 64, torch.bfloat16, cuda))
    mods = _mods(2, 64, cuda)
    norm = _params(64, torch.bfloat16, cuda)[0]["norm"]
    launches, plain = native.launches("adaln_zero_join"), native.launches("adaln_zero_join_plain")
    adaln_zero_join((text, ref, video), mods, norm, EPS)
    assert (native.launches("adaln_zero_join"), native.launches("adaln_zero_join_plain")) == (launches, plain + 1)
    with torch.no_grad():  # the same call without a gradient takes the kernel
        adaln_zero_join((text, ref, video), mods, norm, EPS)
    assert (native.launches("adaln_zero_join"), native.launches("adaln_zero_join_plain")) == (launches + 1, plain + 1)


# (B, (T, R, V), D): ragged rows past a block, a zero-width ref, widths
# below, at and between the kernel's vector buckets
SMALL = [(1, (5, 7, 12), 64), (2, (9, 0, 21), 96), (2, (3, 17, 40), 1920), (1, (2, 3, 5), 3072),
         (2, (4, 4, 33), 4096)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("shape", SMALL, ids=lambda s: f"{s[0]}x{'-'.join(map(str, s[1]))}x{s[2]}")
def test_kernel_matches_emulation_and_chain(cuda, dtype, shape):
    b, lens, d = shape
    streams = _streams(b, lens, d, dtype, cuda, seed=d + sum(lens))
    _kernel_case(streams, _mods(b, d, cuda), _params(d, dtype, cuda)[0]["norm"])


@pytest.mark.gpu
def test_kernel_on_strided_streams_and_fp32_norm_params(cuda):
    """Streams that are views (rows of a wider tensor, a batch stride of
    another stream's), modulation rows of two tensors, fp32 norm params
    (rounded to the streams' dtype, as the plain chain applies them)."""
    wide = _streams(2, (30,), 3 * 256, torch.bfloat16, cuda, seed=12)[0]
    text, ref = wide[:, :6, :256], wide[:, 6:, 512:]
    assert not text.is_contiguous() and not ref.is_contiguous()
    video = _streams(3, (25,), 256, torch.bfloat16, cuda, seed=13)[0][1:]
    base, merged = _mods(2, 256, cuda, seed=14), _mods(2, 256, cuda, seed=15)
    _kernel_case((text, ref, video), (base[1], merged[0], base[0]), _params(256, torch.float32, cuda)[0]["norm"])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_norm_out_takes_one_launch(cuda, dtype):
    """The output AdaLayerNorm through the model's own function: the video
    rows of the joint sequence, one stream, one launch."""
    joint = _streams(2, (226 + 300,), 128, dtype, cuda, seed=16)[0]
    params, _ = _params(128, dtype, cuda, seed=17, chunks=2)
    temb = _temb(2, dtype, cuda)
    launches = native.launches("adaln_zero_join")
    got = ada_layer_norm_out(params, joint[:, 226:], temb, EPS)
    torch.cuda.synchronize()
    assert native.launches("adaln_zero_join") == launches + 1
    shift, scale = torch.nn.functional.linear(torch.nn.functional.silu(temb.float()), params["linear"]["weight"],
                                              params["linear"]["bias"]).chunk(2, dim=-1)
    _assert_within_ulp(got, adaln_zero_join_emulated((joint[:, 226:],), ((shift, scale),), params["norm"], EPS))


@pytest.mark.gpu
@pytest.mark.parametrize("base", [False, True])
def test_block_modulation_takes_one_launch(cuda, base):
    """``ada_layer_norm_zero_joined`` as the blocks call it, merged and
    disentangled: one launch, held to the old three streams and cat."""
    text, ref, video = _streams(2, (11, 16, 48), 192, torch.bfloat16, cuda, seed=18)
    params, base_linear = _params(192, torch.bfloat16, cuda, seed=19, base=base)
    temb = _temb(2, torch.bfloat16, cuda)
    launches = native.launches("adaln_zero_join")
    joined, gates = ada_layer_norm_zero_joined(params, video, text, ref, temb, EPS, base_linear=base_linear)
    torch.cuda.synchronize()
    assert native.launches("adaln_zero_join") == launches + 1
    want, want_gates = _old_block_join(params, video, text, ref, temb, base_linear)
    _assert_within(joined, want)
    for g, w in zip(gates, want_gates):
        assert torch.equal(g, w)


MAIN = {"5b": (2, (226, 1350, 17550), 3072, torch.bfloat16), "2b": (2, (226, 1350, 17550), 1920, torch.float16),
        "1.5": (2, (226, 4080, 44880), 3072, torch.bfloat16)}


@pytest.mark.gpu
@pytest.mark.parametrize("model", sorted(MAIN))
def test_kernel_at_the_main_shapes(cuda, model):
    """The joined rows of a batched-CFG step: 5b bf16 [2, 19126, 3072], 2b
    fp16 [2, 19126, 1920], 1.5 bf16 [2, 49186, 3072] (302 M values: the
    64-bit offsets)."""
    b, lens, d, dtype = MAIN[model]
    streams = _streams(b, lens, d, dtype, cuda, seed=20)
    _kernel_case(streams, _mods(b, d, cuda), _params(d, dtype, cuda)[0]["norm"])
