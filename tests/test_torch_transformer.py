"""The port's tiny DiT forward against the JAX package's, with the weights
carried across by ``transformer_from_jax``."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from _torch_parity import perturb, rand, t
from s2v_tpu.config import TransformerConfig as JTransformerConfig
from s2v_tpu.models.transformer import init_transformer_params, transformer_forward as j_forward
from s2v_tpu.ops.rope import build_segmented_rope, get_3d_rotary_pos_embed
from s2v_torch.config import TransformerConfig
from s2v_torch.loaders.jax_params import transformer_from_jax
from s2v_torch.models.transformer import init_transformer_params_random, transformer_forward
from s2v_torch.pipelines.s2v import S2VPipeline

# fp32 through 2 blocks of ~10 reductions each; outputs are O(1)
ATOL, RTOL = 1e-4, 1e-4


def _case(with_ref):
    cfg_j = JTransformerConfig.tiny()
    params = perturb(init_transformer_params(jax.random.PRNGKey(0), cfg_j), seed=1)
    b, f, h, w = 2, 2, 8, 8
    c = cfg_j.in_channels
    video = rand(b, f, h, w, c, seed=2)
    ref = rand(b, 1, h, w, c, seed=3) if with_ref else None
    text = rand(b, cfg_j.max_text_seq_length, cfg_j.text_embed_dim, seed=4)
    ts = np.array([999, 500], np.int32)
    gh, gw = h // 2, w // 2
    n_frames = f + 1 if with_ref else f
    cos, sin = get_3d_rotary_pos_embed(cfg_j.attention_head_dim, ((0, 0), (gh, gw)), (gh, gw), n_frames)
    tok = gh * gw if with_ref else 0
    cs, sn = build_segmented_rope(cfg_j.max_text_seq_length, cos[:tok], sin[:tok], cos[tok:], sin[tok:])
    want = j_forward(params, cfg_j, jnp.asarray(video), None if ref is None else jnp.asarray(ref),
                     jnp.asarray(text), jnp.asarray(ts), cs, sn, attention_backend="xla")
    return params, (video, ref, text, ts, np.asarray(cs), np.asarray(sn)), np.asarray(want)


@pytest.mark.parametrize("backend", ["plain", "flash"])
@pytest.mark.parametrize("with_ref", [True, False], ids=["3stream", "no_ref"])
def test_forward_matches_jax(with_ref, backend):
    params, (video, ref, text, ts, cs, sn), want = _case(with_ref)
    cfg = TransformerConfig.tiny()
    params_t = transformer_from_jax(params, cfg, device="cpu")
    got = transformer_forward(params_t, cfg, t(video), None if ref is None else t(ref), t(text),
                              torch.from_numpy(ts), t(cs), t(sn), attention_backend=backend)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


def test_separate_qkv_kernels_are_fused():
    """A tree with to_q/to_k/to_v converts to the same fused qkv."""
    cfg_j = JTransformerConfig.tiny()
    params = perturb(init_transformer_params(jax.random.PRNGKey(0), cfg_j), seed=1)
    split = jax.tree.map(lambda a: a, params)
    qkv = split["blocks"]["attn"].pop("qkv")
    d = cfg_j.inner_dim
    for i, name in enumerate(("to_q", "to_k", "to_v")):
        split["blocks"]["attn"][name] = {"kernel": qkv["kernel"][..., i * d:(i + 1) * d],
                                         "bias": qkv["bias"][..., i * d:(i + 1) * d]}
    cfg = TransformerConfig.tiny()
    a = transformer_from_jax(params, cfg, device="cpu")["blocks"][1]["attn"]["qkv"]
    b = transformer_from_jax(split, cfg, device="cpu")["blocks"][1]["attn"]["qkv"]
    assert torch.equal(a["weight"], b["weight"]) and torch.equal(a["bias"], b["bias"])


def test_random_init_shapes_and_forward():
    cfg = TransformerConfig.tiny()
    params = init_transformer_params_random(cfg, seed=0, device="cpu")
    assert len(params["blocks"]) == cfg.num_layers
    assert params["blocks"][0]["attn"]["qkv"]["weight"].shape == (3 * cfg.inner_dim, cfg.inner_dim)
    out = transformer_forward(params, cfg, torch.randn(1, 2, 4, 4, 4), torch.randn(1, 1, 4, 4, 4),
                              torch.randn(1, 16, 32), torch.tensor([10]))
    assert out.shape == (1, 2, 4, 4, 4) and torch.isfinite(out).all()


def test_entry_points_need_a_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        init_transformer_params_random(TransformerConfig.tiny())
    with pytest.raises(RuntimeError):
        S2VPipeline({}, TransformerConfig.tiny(), {}, None)


def _with_base_linears(params, seed):
    """The JAX tree with a pre-merge ``base_linear`` (its own perturbed
    values) beside each block's norm1/norm2 ``linear``."""
    rng = np.random.RandomState(seed)
    for n in ("norm1", "norm2"):
        lin = params["blocks"][n]["linear"]
        params["blocks"][n]["base_linear"] = {
            k: (v + 0.1 * rng.randn(*v.shape)).astype(np.float32) for k, v in lin.items()}
    return params


@pytest.mark.parametrize("with_ref", [True, False], ids=["3stream", "no_ref"])
def test_forward_with_disentangled_modulation_matches_jax(with_ref):
    """Video and text modulated by ``base_linear``, the ref stream by
    ``linear`` (s2v_tpu/ops/adaln.py:44-60); without the config flag the
    base linears are ignored, as in JAX."""
    params, (video, ref, text, ts, cs, sn), plain_want = _case(with_ref)
    params = _with_base_linears(params, seed=5)
    cfg_j = JTransformerConfig.tiny(disentangled_modulation=True)
    want = j_forward(params, cfg_j, jnp.asarray(video), None if ref is None else jnp.asarray(ref), jnp.asarray(text),
                     jnp.asarray(ts), jnp.asarray(cs), jnp.asarray(sn), attention_backend="xla")
    cfg = TransformerConfig.tiny(disentangled_modulation=True)
    params_t = transformer_from_jax(params, cfg, device="cpu")
    args = (t(video), None if ref is None else t(ref), t(text), torch.from_numpy(ts), t(cs), t(sn))
    got = transformer_forward(params_t, cfg, *args, attention_backend="plain")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)
    assert np.abs(got.numpy() - plain_want).max() > 100 * ATOL  # the base linears moved it
    ignored = transformer_forward(params_t, TransformerConfig.tiny(), *args, attention_backend="plain")
    np.testing.assert_allclose(ignored.numpy(), plain_want, atol=ATOL, rtol=RTOL)


# fp16 storage on both sides: the port's flash backend gives B1's plain
# version the fp16 q/k/v (fp32 inside, cast back once), JAX upcasts them to
# fp32 before attention and casts back (s2v_tpu/ops/attention.py:208-214);
# every other op rounds to fp16 in both, in possibly another order, so the
# bar is a few fp16 ulps (2^-11 relative) of outputs of O(1) through 2 blocks
FP16_ATOL, FP16_RTOL = 2e-2, 2e-2


@pytest.mark.parametrize("backend", ["flash", "plain"])
def test_forward_in_fp16_matches_jax(backend):
    cfg_j = JTransformerConfig.tiny(dtype=jnp.float16, param_dtype=jnp.float16)
    params, (video, ref, text, ts, cs, sn), _ = _case(True)
    jparams = jax.tree.map(lambda a: jnp.asarray(a, jnp.float16), params)
    want = j_forward(jparams, cfg_j, jnp.asarray(video), jnp.asarray(ref), jnp.asarray(text), jnp.asarray(ts),
                     jnp.asarray(cs), jnp.asarray(sn), attention_backend="xla")
    assert want.dtype == jnp.float16
    cfg = TransformerConfig.tiny(dtype=torch.float16)
    got = transformer_forward(transformer_from_jax(params, cfg, device="cpu"), cfg, t(video), t(ref), t(text),
                              torch.from_numpy(ts), t(cs), t(sn), attention_backend=backend)
    assert got.dtype == torch.float16 and torch.isfinite(got).all()
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=FP16_ATOL, rtol=FP16_RTOL)
