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
