"""The port's int8 linears (``s2v_torch/ops/quant.py``) against the JAX
package's (``s2v_tpu/ops/quant.py``) on the same numpy inputs: the weight
quantizer, ``int8_dense`` forward and its straight-through backward, ``dense``
on an int8 leaf with LoRA pairs, the quantized tree carried across, and the
tiny DiT forward on an int8 tree.  The JAX functions run jitted, as in the
JAX package's pipelines: XLA then computes ``amax / 127.0`` as a multiply by
the fp32 reciprocal, which the port does on purpose (the same on both of its
devices); op-by-op JAX divides and differs in the last bit of ~5% of the
scales."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from _torch_parity import perturb, quantized, rand, t
from s2v_tpu.config import TransformerConfig as JTransformerConfig
from s2v_tpu.models.transformer import init_transformer_params, transformer_forward as j_forward
from s2v_tpu.ops import quant as j_quant
from s2v_torch.config import TransformerConfig
from s2v_torch.loaders.jax_params import transformer_from_jax
from s2v_torch.models.transformer import transformer_forward
from s2v_torch.ops.quant import QUANTIZED_LEAVES, dense, int8_dense, quantize_transformer_params, quantize_weight_int8

# bf16 outputs: the same fp32 value rounded once to bf16 on both sides, or
# values one summation order apart rounded to neighbouring bf16 numbers:
# at most one bf16 ulp, 2^-7 of the value (plus 1e-6 of the largest |value|
# for elements whose fp32 sums cancel to near zero)
BF16_ULP_REL = 2.0 ** -7


def _weights(d_in, d_out, seed):
    """A kernel [in, out] with one all-zero output column (scale 0 -> 1)."""
    w = rand(d_in, d_out, seed=seed) * 0.1
    w[:, 3] = 0.0
    return w


def _to_dtype(a, dtype):
    return t(a).to(dtype)


def _within_one_bf16_ulp(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    bar = BF16_ULP_REL * np.abs(want) + 1e-6 * np.abs(want).max()
    assert (np.abs(got - want) <= bar).all(), np.abs(got - want).max()


@pytest.mark.parametrize("lead", [(), (3,)], ids=["2d", "stacked"])
def test_quantize_weight_int8_is_bit_equal(lead):
    w = rand(*lead, 48, 40, seed=0) * 0.1
    w[..., 5] = 0.0
    want = jax.jit(j_quant.quantize_weight_int8)(jnp.asarray(w))
    got = quantize_weight_int8(t(np.swapaxes(w, -1, -2)))
    assert got["q"].dtype == torch.int8 and got["scale"].dtype == torch.float32
    np.testing.assert_array_equal(np.swapaxes(got["q"].numpy(), -1, -2), np.asarray(want["q"]))
    np.testing.assert_array_equal(got["scale"].numpy(), np.asarray(want["scale"])[..., 0, :])
    assert (got["scale"][..., 5] == 1.0).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_dense_forward_matches_jax(dtype):
    w, b = _weights(64, 40, seed=1), rand(40, seed=2)
    x = rand(3, 37, 64, seed=3)
    x[0, 4] = 0.0  # an all-zero row: x_scale 0 -> 1
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    wq_j = jax.jit(j_quant.quantize_weight_int8)(jnp.asarray(w))
    want = np.asarray(jax.jit(j_quant.int8_dense)(jnp.asarray(x).astype(jd), wq_j,
                                                  jnp.asarray(b).astype(jd)).astype(jnp.float32))
    wq = quantize_weight_int8(t(w.T))
    got = int8_dense(_to_dtype(x, td), wq, _to_dtype(b, td))
    assert got.dtype == td and got.shape == (3, 37, 40)
    got = got.float().numpy()
    if dtype == "float32":
        # the same operations in the same order on exact int32 products
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())
    else:
        _within_one_bf16_ulp(got, want)
    # and it is the quantized product, not the exact one (<2% RMS off it)
    exact = x @ w + b
    rms = np.sqrt(np.mean((got - exact) ** 2)) / np.sqrt(np.mean(exact ** 2))
    assert 1e-6 < rms < 0.02


def test_dense_int8_leaf_with_lora_pairs_matches_jax():
    w, b = _weights(24, 32, seed=4), rand(32, seed=5)
    pairs = [(rand(24, 3, seed=6 + i), rand(3, 32, seed=8 + i)) for i in range(2)]
    x = rand(2, 19, 24, seed=10)
    leaf_j = {**jax.jit(j_quant.quantize_weight_int8)(jnp.asarray(w)), "bias": jnp.asarray(b),
              "lora": tuple((jnp.asarray(a), jnp.asarray(bb)) for a, bb in pairs)}
    want = np.asarray(jax.jit(j_quant.dense)(leaf_j, jnp.asarray(x)))
    leaf = {**quantize_weight_int8(t(w.T)), "bias": t(b), "lora": tuple((t(a), t(bb)) for a, bb in pairs)}
    got = dense(leaf, t(x)).numpy()
    # fp32; the LoRA products differ from XLA's only in summation order
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    no_lora = dense({k: v for k, v in leaf.items() if k != "lora"}, t(x)).numpy()
    assert np.abs(got - no_lora).max() > 1e-2  # the pairs were applied


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_mm_backward_matches_jax_vjp(dtype):
    w = _weights(40, 24, seed=11)
    x, g = rand(3, 7, 40, seed=12), rand(3, 7, 24, seed=13)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    wq_j = jax.jit(j_quant.quantize_weight_int8)(jnp.asarray(w))

    @jax.jit
    def vjp_x(xx, gg):
        return jax.vjp(lambda a: j_quant._int8_mm(a, wq_j["q"], wq_j["scale"]), xx)[1](gg)[0]

    want = np.asarray(vjp_x(jnp.asarray(x).astype(jd), jnp.asarray(g).astype(jd)).astype(jnp.float32))
    xt = _to_dtype(x, td).requires_grad_()
    y = int8_dense(xt, quantize_weight_int8(t(w.T)))
    (got,) = torch.autograd.grad(y, xt, _to_dtype(g, td))
    assert got.dtype == td
    got = got.float().numpy()
    if dtype == "float32":
        # the same bf16-rounded operands, exact products, fp32 sums in another order
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())
    else:
        _within_one_bf16_ulp(got, want)
    assert np.abs(got).max() > 0.0


def test_quantized_tree_carried_across_equals_port_quantization():
    cfg_j = JTransformerConfig.tiny()
    base = perturb(init_transformer_params(jax.random.PRNGKey(0), cfg_j), seed=1)
    cfg = TransformerConfig.tiny()
    carried = transformer_from_jax(quantized(base), cfg, device="cpu")
    mine = quantize_transformer_params(transformer_from_jax(base, cfg, device="cpu"))
    flat = lambda p: jax.tree_util.tree_flatten_with_path(p)[0]  # noqa: E731
    got, want = flat(carried), flat(mine)
    assert [k for k, _ in got] == [k for k, _ in want]
    for (path, a), (_, b) in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    for layer in carried["blocks"]:
        for group, name in QUANTIZED_LEAVES:
            leaf = layer[group][name]
            assert sorted(leaf) == ["bias", "q", "scale"] and leaf["q"].dtype == torch.int8
    # a bf16 model config leaves q int8 and the scale fp32
    bf16 = transformer_from_jax(quantized(base), TransformerConfig.tiny(dtype=torch.bfloat16), device="cpu")
    qkv = bf16["blocks"][1]["attn"]["qkv"]
    assert (qkv["q"].dtype, qkv["scale"].dtype, qkv["bias"].dtype) == (torch.int8, torch.float32, torch.bfloat16)
    assert torch.equal(qkv["q"], carried["blocks"][1]["attn"]["qkv"]["q"])
    assert qkv["q"].shape == (3 * cfg.inner_dim, cfg.inner_dim) and qkv["scale"].shape == (3 * cfg.inner_dim,)


def test_int8_transformer_forward_matches_jax():
    """fp32 on both sides, exact attention (JAX ``xla``, the port's
    ``plain``).  The int8 values agree unless a last-bit difference upstream
    moves ``x / x_scale`` across a .5 and flips one activation by one int8
    step, which moves that token's linear output by ~x_scale·|w|; through
    the next block's attention it reaches many tokens.  These inputs have
    one such flip: 1.4e-3 of the largest output at most and 5.3e-4 in
    relative L2 (without a flip, other seeds give 2.5e-7, the fp32 bar of
    the bf16 tree).  The bars, 5e-3 and 2e-3, allow a few flips; a wrong
    layout or scale moves the output by percents."""
    cfg_j = JTransformerConfig.tiny()
    base = perturb(init_transformer_params(jax.random.PRNGKey(0), cfg_j), seed=1)
    jq = quantized(base)
    b, f, h, w = 2, 2, 8, 8
    video, ref = rand(b, f, h, w, cfg_j.in_channels, seed=2), rand(b, 1, h, w, cfg_j.in_channels, seed=3)
    text = rand(b, cfg_j.max_text_seq_length, cfg_j.text_embed_dim, seed=4)
    ts = np.array([999, 300], np.int32)
    want = np.asarray(j_forward(jax.tree.map(jnp.asarray, jq), cfg_j, jnp.asarray(video), jnp.asarray(ref),
                                jnp.asarray(text), jnp.asarray(ts)))
    cfg = TransformerConfig.tiny()
    got = transformer_forward(transformer_from_jax(jq, cfg, device="cpu"), cfg, t(video), t(ref), t(text),
                              torch.from_numpy(ts)).numpy()
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 5e-3 * scale
    assert np.linalg.norm(got - want) <= 2e-3 * np.linalg.norm(want)
    # the int8 tree is not the fp32 one (the JAX test's bar: within 10% RMS)
    fp32 = np.asarray(j_forward(jax.tree.map(jnp.asarray, base), cfg_j, jnp.asarray(video), jnp.asarray(ref),
                                jnp.asarray(text), jnp.asarray(ts)))
    rel = np.sqrt(np.mean((got - fp32) ** 2)) / np.sqrt(np.mean(fp32 ** 2))
    assert 1e-5 < rel < 0.10
