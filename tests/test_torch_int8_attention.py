"""Kernel B3's plain version (``s2v_torch/kernels/int8_attention.py``), the
``flash_int8`` attention backend and a tiny int8 ``S2VPipeline.generate``
against the JAX package: ``flash_attention_qk_int8`` in interpret mode, its
``pallas_int8`` backend and the JAX pipeline, on the same numpy inputs.  The
CUDA kernel itself is held against the plain version on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py``)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from _torch_parity import perturb, quantized, rand, t
from s2v_tpu.ops.pallas import int8_attention as j_int8
from s2v_torch.kernels.int8_attention import (
    flash_attention_qk_int8,
    flash_attention_qk_int8_reference,
    int8_prepass,
)
from s2v_torch.ops.attention import int8_attention_inference_only

# fp32 inputs: the same int8 values and dequant scalar on both sides, so
# the logits agree exactly; the JAX kernel's blocked online softmax and the
# plain version's one-pass softmax differ by fp32 rounding only
FP32_ATOL = 1e-5
# bf16 inputs: kernel B1's limits (the JAX kernel rounds P to bf16 for P·V,
# the plain version keeps it fp32; both round the output to bf16)
OUT_MAX_REL = 2.0 ** -6
OUT_L2_REL = 1e-2


def _jax_int8(q, k, v, **kw):
    return np.asarray(j_int8.flash_attention_qk_int8(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                                     interpret=True, **kw).astype(jnp.float32))


def _jax_prepass(q, k, scale):
    """The JAX wrapper's int8 values (folded to [B·H, S, d]) and dequant,
    jitted as inside ``flash_attention_qk_int8``."""
    fold = lambda x: x.transpose(0, 2, 1, 3).reshape(-1, x.shape[1], x.shape[3])  # noqa: E731

    @jax.jit
    def prepass(q, k):
        q_i8, qs = j_int8._quantize_tensor(fold(q) * jnp.asarray(scale, jnp.float32))
        k_i8, ks = j_int8._quantize_tensor(fold(k))
        return q_i8, k_i8, qs * ks

    q_i8, k_i8, dq = prepass(jnp.asarray(q), jnp.asarray(k))
    return np.asarray(q_i8), np.asarray(k_i8), np.float32(dq)


def _fold(x):
    return x.transpose(1, 2).reshape(-1, x.shape[1], x.shape[3]).numpy()


def _assert_b1_limits(got, want):
    diff = got - want
    assert np.abs(diff).max() <= OUT_MAX_REL * np.abs(want).max()
    assert np.linalg.norm(diff) < OUT_L2_REL * np.linalg.norm(want)


# (B, Sq, Skv, H, d): ragged against the JAX test's 32/64 blocks, Sq != Skv, d = 32 and 64
SHAPES = [(2, 90, 90, 2, 64), (1, 77, 200, 3, 64), (1, 90, 90, 2, 32), (2, 200, 33, 1, 64)]


@pytest.mark.parametrize("b,sq,skv,h,d", SHAPES)
def test_reference_matches_jax_interpret_fp32(b, sq, skv, h, d):
    rng = np.random.RandomState(sq + skv + d)
    q, k, v = (rng.randn(b, s, h, d).astype(np.float32) for s in (sq, skv, skv))
    want = _jax_int8(q, k, v, block_q=32, block_k=64)
    got = flash_attention_qk_int8(t(q), t(k), t(v))  # CPU tensors: the plain version
    assert got.dtype == torch.float32 and got.shape == (b, sq, h, d)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=FP32_ATOL)
    # the pre-pass is bit-equal to the JAX wrapper's
    q_i8, k_i8, dq = int8_prepass(t(q), t(k), d ** -0.5)
    jq, jk, jdq = _jax_prepass(q, k, d ** -0.5)
    assert q_i8.dtype == k_i8.dtype == torch.int8 and dq.shape == (1,) and dq.dtype == torch.float32
    np.testing.assert_array_equal(_fold(q_i8), jq)
    np.testing.assert_array_equal(_fold(k_i8), jk)
    assert dq.item() == jdq
    # and it is the int8 path, not exact attention
    exact = np.asarray(jax.nn.dot_product_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    assert 1e-6 < np.abs(got.numpy() - exact).max() < 0.05


def test_negative_logit_rows_with_ragged_tail():
    """``tests/test_quant.py``'s regression: every real scaled logit is about
    -90, and block_k = 64 leaves 38 padded keys in the JAX kernel.  A pad key
    that became an int8 zero would give logit 0, pin the softmax max and
    underflow every real probability to an all-zero row."""
    rng = np.random.RandomState(1)
    b, s, h, d = 1, 90, 1, 32
    q = np.ones((b, s, h, d), np.float32) * 4.0
    k = -np.ones((b, s, h, d), np.float32) * 4.0 + rng.randn(b, s, h, d).astype(np.float32) * 0.01
    v = rng.randn(b, s, h, d).astype(np.float32)
    got = flash_attention_qk_int8(t(q), t(k), t(v)).numpy()
    np.testing.assert_allclose(got, _jax_int8(q, k, v, block_q=32, block_k=64), rtol=0, atol=FP32_ATOL)
    exact = np.asarray(jax.nn.dot_product_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    assert np.abs(got - exact).max() < 0.05  # the JAX test's bar against exact attention
    assert np.abs(got).max() > 0.01  # not the all-zero failure


def test_bf16_inputs_within_b1_limits():
    rng = np.random.RandomState(3)
    q, k, v = (rng.randn(2, s, 2, 64).astype(np.float32) for s in (200, 150, 150))
    bf = lambda x: jnp.asarray(x).astype(jnp.bfloat16)  # noqa: E731
    want = np.asarray(j_int8.flash_attention_qk_int8(bf(q), bf(k), bf(v), block_q=64, block_k=64,
                                                      interpret=True).astype(jnp.float32))
    got = flash_attention_qk_int8(*(t(x).to(torch.bfloat16) for x in (q, k, v)))
    assert got.dtype == torch.bfloat16
    _assert_b1_limits(got.float().numpy(), want)


def test_scale_is_shared_across_the_batch():
    """One scale over all rows and heads, as the JAX wrapper: the uncond and
    cond halves of batched CFG (here of different magnitudes) share it, so a
    row's result depends on the other half."""
    rng = np.random.RandomState(4)
    q, k, v = (rng.randn(2, 70, 2, 64).astype(np.float32) for _ in range(3))
    q[1] *= 3.0
    k[1] *= 0.25
    want = _jax_int8(q, k, v)
    got = flash_attention_qk_int8(t(q), t(k), t(v)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=FP32_ATOL)
    q_i8, k_i8, _ = int8_prepass(t(q), t(k), 0.125)
    jq, jk, _ = _jax_prepass(q, k, 0.125)
    np.testing.assert_array_equal(_fold(q_i8), jq)
    np.testing.assert_array_equal(_fold(k_i8), jk)
    alone = flash_attention_qk_int8(t(q[:1]), t(k[:1]), t(v[:1])).numpy()
    assert np.abs(alone - got[:1]).max() > 1e-4  # row 0 alone gets its own scale


@pytest.fixture
def jax_int8_interpret(monkeypatch):
    """JAX ``pallas_int8`` on the CPU: its kernel in interpret mode (the
    JAX package's tests run it the same way)."""
    orig = j_int8.flash_attention_qk_int8

    def interpreted(q, k, v, scale=None, interpret=False, **kw):
        return orig(q, k, v, scale=scale, interpret=True, **kw)

    monkeypatch.setattr(j_int8, "flash_attention_qk_int8", interpreted)


def test_joint_attention_flash_int8_matches_jax(jax_int8_interpret):
    """fp32 ``joint_attention`` through qkv, qk-norm and RoPE, then int8-QK
    attention and the output linear.  An upstream last-bit difference can
    move one ``q·scale/qs`` across a .5 and flip one int8 step, changing
    that query's logits by up to ``dq·|k_i8|`` ≤ ``dq·127`` (about 1e-2
    here): 2e-3 of the largest output allows a flip.  These inputs have
    none and agree to 2.6e-7 of the largest output."""
    from s2v_tpu.config import TransformerConfig as JTransformerConfig
    from s2v_tpu.models.transformer import init_transformer_params
    from s2v_tpu.ops.attention import joint_attention as j_joint_attention
    from s2v_tpu.ops.rope import build_segmented_rope, get_3d_rotary_pos_embed
    from s2v_torch.config import TransformerConfig
    from s2v_torch.loaders.jax_params import transformer_from_jax
    from s2v_torch.ops.attention import joint_attention

    cfg_j = JTransformerConfig.tiny()
    base = perturb(init_transformer_params(jax.random.PRNGKey(0), cfg_j), seed=1)
    attn_j = jax.tree.map(lambda a: jnp.asarray(a[0]), base["blocks"]["attn"])
    attn = transformer_from_jax(base, TransformerConfig.tiny(), device="cpu")["blocks"][0]["attn"]
    gh = gw = 4
    cos, sin = get_3d_rotary_pos_embed(cfg_j.attention_head_dim, ((0, 0), (gh, gw)), (gh, gw), 3)
    tok = gh * gw
    cs, sn = (np.asarray(a) for a in build_segmented_rope(cfg_j.max_text_seq_length, cos[:tok], sin[:tok],
                                                           cos[tok:], sin[tok:]))
    x = rand(2, cs.shape[0], cfg_j.inner_dim, seed=5)
    heads = cfg_j.num_attention_heads
    want = np.asarray(j_joint_attention(attn_j, jnp.asarray(x), heads, jnp.asarray(cs), jnp.asarray(sn),
                                        backend="pallas_int8"))
    got = joint_attention(attn, t(x), heads, t(cs), t(sn), backend="flash_int8").numpy()
    assert np.abs(got - want).max() <= 2e-3 * np.abs(want).max()
    exact = joint_attention(attn, t(x), heads, t(cs), t(sn), backend="plain").numpy()
    assert np.abs(got - exact).max() > 1e-5  # the int8 path ran


def test_backward_raises():
    q, k, v = (t(rand(1, 20, 2, 64, seed=i)).requires_grad_() for i in range(3))
    out = int8_attention_inference_only(q, k, v)
    with pytest.raises(NotImplementedError, match="inference-only"):
        out.sum().backward()
    with torch.no_grad():  # without autograd it is the plain call
        np.testing.assert_array_equal(int8_attention_inference_only(q, k, v).numpy(),
                                      flash_attention_qk_int8_reference(q, k, v).numpy())


def test_int8_generate_matches_jax(jax_int8_interpret):
    """A tiny ``generate`` on an int8 DiT with int8-QK attention in both
    packages: the JAX tree quantized by the JAX package and carried across,
    the same injected latents, ref latents and prompt embeddings, 2 DDIM
    steps with batched CFG at g = 6.  fp32 activations; a last-bit
    difference upstream can flip one int8 step of an activation or a q/k
    element, and the guidance mix amplifies it 2g - 1 = 11 times: 1e-2 of
    the largest latent allows a few flips (a wrong layout or scale moves
    the latents by tens of percents).  These inputs agree to 1.9e-6."""
    from s2v_tpu.config import SchedulerConfig as JSchedulerConfig
    from s2v_tpu.config import TransformerConfig as JTransformerConfig
    from s2v_tpu.config import VAEConfig as JVAEConfig
    from s2v_tpu.models.transformer import init_transformer_params
    from s2v_tpu.models.vae import init_vae_params
    from s2v_tpu.pipelines.s2v import S2VPipeline as JS2VPipeline
    from s2v_torch.config import TransformerConfig, VAEConfig
    from s2v_torch.loaders.jax_params import transformer_from_jax, vae_from_jax
    from s2v_torch.pipelines.s2v import S2VPipeline

    vae_kw = dict(latent_channels=4, sample_height=64, sample_width=64)
    tcfg_j, vcfg_j = JTransformerConfig.tiny(), JVAEConfig.tiny(**vae_kw)
    tp = quantized(perturb(init_transformer_params(jax.random.PRNGKey(0), tcfg_j), seed=1, scale=0.05))
    vp = perturb(init_vae_params(jax.random.PRNGKey(1), vcfg_j), seed=2, scale=0.05)
    jax_pipe = JS2VPipeline(transformer_params=jax.tree.map(jnp.asarray, tp), transformer_cfg=tcfg_j,
                            vae_params=jax.tree.map(jnp.asarray, vp), vae_cfg=vcfg_j, scheduler_cfg=JSchedulerConfig())
    tcfg, vcfg = TransformerConfig.tiny(), VAEConfig.tiny(**vae_kw)
    port = S2VPipeline(transformer_params=transformer_from_jax(tp, tcfg, device="cpu"), transformer_cfg=tcfg,
                       vae_params=vae_from_jax(vp, vcfg, device="cpu"), vae_cfg=vcfg, device="cpu")
    jax_pipe.set_attention("pallas_int8")
    port.set_attention("flash_int8")
    latents, ref, embeds = rand(1, 3, 4, 4, 4, seed=10), rand(1, 1, 4, 4, 4, seed=11), rand(2, 16, 32, seed=12)
    common = dict(height=32, width=32, num_frames=9, num_inference_steps=2, guidance_scale=6.0,
                  output_type="latent")
    want = np.asarray(jax_pipe.generate(latents=jnp.asarray(latents), ref_latents=jnp.asarray(ref),
                                        prompt_embeds=jnp.asarray(embeds), **common))
    got = port.generate(latents=t(latents), ref_latents=t(ref), prompt_embeds=t(embeds), **common).numpy()
    assert got.shape == (1, 3, 4, 4, 4) and np.isfinite(got).all()
    assert np.abs(got - want).max() <= 1e-2 * np.abs(want).max()
    port.set_attention("plain")
    exact = port.generate(latents=t(latents), ref_latents=t(ref), prompt_embeds=t(embeds), **common).numpy()
    assert np.abs(got - exact).max() > 1e-5  # int8-QK attention ran

