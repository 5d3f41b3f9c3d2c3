"""The windowed attention path of the port against the JAX package's
kernel-free ``windowed_xla`` backend, in fp32 on the tiny configs: the gather
path and the masked reference, the DiT forward (3-stream and no-ref), a tiny
``generate`` after ``set_attention``, and the LoRA loss, grads and one
train step.  The JAX ``windowed`` backend needs its Pallas kernels off
interpret mode, so the whole paths are held against ``windowed_xla``; the
port's ``windowed`` backend runs B4/B5's plain versions on CPU tensors."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from _torch_parity import band_inputs, np_tree, perturb, rand, t
from s2v_tpu.config import SchedulerConfig as JSchedulerConfig
from s2v_tpu.config import TransformerConfig as JTransformerConfig
from s2v_tpu.config import VAEConfig as JVAEConfig
from s2v_tpu.models.transformer import init_transformer_params, transformer_forward as j_forward
from s2v_tpu.models.vae import init_vae_params
from s2v_tpu.ops.rope import build_segmented_rope, get_3d_rotary_pos_embed
from s2v_tpu.ops.windowed_attention import windowed_attention as j_windowed_attention
from s2v_tpu.ops.windowed_attention import windowed_attention_reference as j_windowed_reference
from s2v_tpu.pipelines.s2v import S2VPipeline as JS2VPipeline
from s2v_tpu.schedulers import ddim as j_ddim
from s2v_tpu.training import lora as j_lora
from s2v_torch.config import TransformerConfig, VAEConfig
from s2v_torch.kernels.flash_attention import flash_attention_reference
from s2v_torch.loaders.jax_params import lora_from_jax, transformer_from_jax, vae_from_jax
from s2v_torch.models.transformer import transformer_forward
from s2v_torch.ops.attention import ATTENTION_BACKENDS, WINDOWED_BACKENDS, joint_attention
from s2v_torch.ops.windowed_attention import windowed_attention, windowed_attention_reference
from s2v_torch.pipelines.s2v import S2VPipeline
from s2v_torch.training import lora

# the attention functions alone: fp32, O(1) outputs, sums in another order
ATTN_ATOL = 1e-5
# fp32 through 2 blocks, as test_torch_transformer.py
ATOL, RTOL = 1e-4, 1e-4
# the loss and its grads: 1e-4 of the largest |value|, as test_torch_training.py
REL_TO_MAX = 1e-4
WINDOW = 1
ALPHAS = np.asarray(j_ddim.compute_alphas_cumprod(JSchedulerConfig()))


def _close_to_max(got, want, rel=REL_TO_MAX):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * max(np.abs(want).max(), 1e-12)


@pytest.mark.parametrize("g,tpf,f,w", [(24, 20, 5, 1), (24, 20, 4, 0), (10, 16, 6, 2), (7, 30, 3, 4)])
def test_gather_path_and_reference_match_jax(g, tpf, f, w):
    q, k, v = band_inputs(2, 3, g, tpf, f, seed=g + f, n=3)
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    want = np.asarray(j_windowed_attention(jq, jk, jv, g, tpf, w, attention_fn=jax.nn.dot_product_attention))
    np.testing.assert_allclose(windowed_attention(tq, tk, tv, g, tpf, w, attention_fn=flash_attention_reference)
                               .numpy(), want, atol=ATTN_ATOL)
    # the default attention function: B1 (its plain version on the CPU)
    np.testing.assert_allclose(windowed_attention(tq, tk, tv, g, tpf, w).numpy(), want, atol=ATTN_ATOL)
    np.testing.assert_allclose(windowed_attention_reference(tq, tk, tv, g, tpf, w).numpy(),
                               np.asarray(j_windowed_reference(jq, jk, jv, g, tpf, w)), atol=ATTN_ATOL)


def _tiny_jax_cfg():
    return JTransformerConfig.tiny(attention_window_frames=WINDOW)


def _forward_case(with_ref, f=4):
    cfg_j = _tiny_jax_cfg()
    params = perturb(init_transformer_params(jax.random.PRNGKey(0), cfg_j), seed=1)
    b, h, w = 2, 8, 8
    c = cfg_j.in_channels
    video = rand(b, f, h, w, c, seed=2)
    ref = rand(b, 1, h, w, c, seed=3) if with_ref else None
    text = rand(b, cfg_j.max_text_seq_length, cfg_j.text_embed_dim, seed=4)
    ts = np.array([999, 500], np.int32)
    gh, gw = h // 2, w // 2
    cos, sin = get_3d_rotary_pos_embed(cfg_j.attention_head_dim, ((0, 0), (gh, gw)), (gh, gw),
                                       f + 1 if with_ref else f)
    tok = gh * gw if with_ref else 0
    cs, sn = build_segmented_rope(cfg_j.max_text_seq_length, cos[:tok], sin[:tok], cos[tok:], sin[tok:])
    want = j_forward(params, cfg_j, jnp.asarray(video), None if ref is None else jnp.asarray(ref),
                     jnp.asarray(text), jnp.asarray(ts), cs, sn, attention_backend="windowed_xla")
    exact = j_forward(params, cfg_j, jnp.asarray(video), None if ref is None else jnp.asarray(ref),
                      jnp.asarray(text), jnp.asarray(ts), cs, sn, attention_backend="xla")
    # with 4 frames and w = 1 the window leaves frames out: it must show
    assert np.abs(np.asarray(want) - np.asarray(exact)).max() > 1e-3
    return params, (video, ref, text, ts, np.asarray(cs), np.asarray(sn)), np.asarray(want)


# the single-card windowed backends; sp_windowed needs a process group
# (tests/test_torch_sp_attention.py)
@pytest.mark.parametrize("backend", [b for b in WINDOWED_BACKENDS if b != "sp_windowed"])
@pytest.mark.parametrize("with_ref", [True, False], ids=["3stream", "no_ref"])
def test_forward_matches_jax_windowed(with_ref, backend):
    params, (video, ref, text, ts, cs, sn), want = _forward_case(with_ref)
    cfg = TransformerConfig.tiny(attention_window_frames=WINDOW)
    got = transformer_forward(transformer_from_jax(params, cfg, device="cpu"), cfg, t(video),
                              None if ref is None else t(ref), t(text), torch.from_numpy(ts), t(cs), t(sn),
                              attention_backend=backend)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


def test_windowed_backend_needs_a_window():
    assert set(WINDOWED_BACKENDS) < set(ATTENTION_BACKENDS)
    cfg = TransformerConfig.tiny()
    d = cfg.inner_dim
    params = {"qkv": {"weight": torch.randn(3 * d, d), "bias": torch.zeros(3 * d)},
              "norm_q": {"weight": torch.ones(16), "bias": torch.zeros(16)},
              "norm_k": {"weight": torch.ones(16), "bias": torch.zeros(16)},
              "to_out": {"weight": torch.randn(d, d), "bias": torch.zeros(d)}}
    with pytest.raises(ValueError):
        joint_attention(params, torch.randn(1, 12, d), cfg.num_attention_heads, backend="windowed")
    out = joint_attention(params, torch.randn(1, 12, d), cfg.num_attention_heads, backend="windowed",
                          window=(4, 4, 0))
    assert out.shape == (1, 12, d)


@pytest.fixture(scope="module")
def pipelines():
    tcfg_j = JTransformerConfig.tiny()
    vcfg_j = JVAEConfig.tiny(latent_channels=4, sample_height=64, sample_width=64)
    tp = perturb(init_transformer_params(jax.random.PRNGKey(0), tcfg_j), seed=1, scale=0.05)
    vp = perturb(init_vae_params(jax.random.PRNGKey(1), vcfg_j), seed=2, scale=0.05)
    jax_pipe = JS2VPipeline(transformer_params=jax.tree.map(jnp.asarray, tp), transformer_cfg=tcfg_j,
                            vae_params=jax.tree.map(jnp.asarray, vp), vae_cfg=vcfg_j,
                            scheduler_cfg=JSchedulerConfig())
    tcfg, vcfg = TransformerConfig.tiny(), VAEConfig.tiny(latent_channels=4, sample_height=64, sample_width=64)
    port = S2VPipeline(transformer_params=transformer_from_jax(tp, tcfg, device="cpu"), transformer_cfg=tcfg,
                       vae_params=vae_from_jax(vp, vcfg, device="cpu"), vae_cfg=vcfg, device="cpu")
    return jax_pipe, port


@pytest.mark.parametrize("backend", ["windowed", "windowed_plain"])
def test_generate_windowed_matches_jax(pipelines, backend):
    """2 DDIM steps with batched CFG over 4 latent frames (13 frames at
    32x32), window 1, embeddings, latents and ref latents injected."""
    jax_pipe, port = pipelines
    jax_pipe.set_attention("windowed_xla", WINDOW)
    port.set_attention(backend, WINDOW)
    assert port.attention_backend == backend and port.transformer_cfg.attention_window_frames == WINDOW
    latents, ref, embeds = rand(1, 4, 4, 4, 4, seed=10), rand(1, 1, 4, 4, 4, seed=11), rand(2, 16, 32, seed=12)
    common = dict(height=32, width=32, num_frames=13, num_inference_steps=2, guidance_scale=6.0,
                  output_type="latent")
    want = np.asarray(jax_pipe.generate(latents=jnp.asarray(latents), ref_latents=jnp.asarray(ref),
                                        prompt_embeds=jnp.asarray(embeds), **common))
    got = port.generate(latents=t(latents), ref_latents=t(ref), prompt_embeds=t(embeds), **common)
    assert got.shape == (1, 4, 4, 4, 4)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=1e-4)
    port.set_attention("auto")
    assert port.attention_backend == "plain" and port.transformer_cfg.attention_window_frames == WINDOW


def _lora_case():
    cfg_j = _tiny_jax_cfg()
    base = perturb(init_transformer_params(jax.random.PRNGKey(0), cfg_j), seed=1)
    b, f, h, w = 2, 4, 8, 8
    c = cfg_j.in_channels
    batch = {"video_latents": rand(b, f, h, w, c, seed=2), "ref_latents": rand(b, 1, h, w, c, seed=3),
             "text_embeds": rand(b, cfg_j.max_text_seq_length, cfg_j.text_embed_dim, seed=4)}
    gh, gw = h // 2, w // 2
    cos, sin = get_3d_rotary_pos_embed(cfg_j.attention_head_dim, ((0, 0), (gh, gw)), (gh, gw), f + 1)
    tok = gh * gw
    cs, sn = build_segmented_rope(cfg_j.max_text_seq_length, cos[:tok], sin[:tok], cos[tok:], sin[tok:])
    batch["rope_cos"], batch["rope_sin"] = np.asarray(cs), np.asarray(sn)
    spec = j_lora.LoRASpec(rank=4, alpha=8.0)
    tree = np_tree(j_lora.init_lora_params(jax.random.PRNGKey(3), base, spec))
    rng = np.random.RandomState(3)
    for ab in tree.values():  # nonzero b, so that a's grads are nonzero too
        ab["b"] = (ab["b"] + 0.1 * rng.randn(*ab["b"].shape)).astype(np.float32)
    return cfg_j, base, batch, spec, tree


def _jax_draws(rng, shape):
    """The draws of s2v_tpu.training.full.vpred_loss (:69-71)."""
    k_t, k_n = jax.random.split(rng)
    ts = jax.random.randint(k_t, (shape[0],), 0, ALPHAS.shape[0])
    return torch.from_numpy(np.array(ts)), t(jax.random.normal(k_n, shape, jnp.float32))


@pytest.mark.parametrize("backend", ["windowed", "windowed_plain"])
def test_lora_loss_and_grads_match_jax_windowed(backend):
    """Remat on: the banded autograd Function runs again in the backward."""
    cfg_j, base, batch, spec, tree = _lora_case()
    rng = jax.random.PRNGKey(11)
    loss_j, grads_j = jax.value_and_grad(j_lora.lora_loss_fn)(
        jax.tree.map(jnp.asarray, tree), base, cfg_j, spec, {k: jnp.asarray(v) for k, v in batch.items()},
        jnp.asarray(ALPHAS), rng, "windowed_xla", True)
    ts, noise = _jax_draws(rng, batch["video_latents"].shape)
    cfg = TransformerConfig.tiny(attention_window_frames=WINDOW)
    mine = lora_from_jax(tree, device="cpu")
    leaves = lora.lora_leaves(mine)
    for x in leaves:
        x.requires_grad_(True)
    loss = lora.lora_loss_fn(mine, transformer_from_jax(base, cfg, device="cpu"), cfg, lora.LoRASpec(rank=4, alpha=8.0),
                             {k: t(v) for k, v in batch.items()}, torch.from_numpy(ALPHAS), None, backend, True,
                             timesteps=ts, noise=noise)
    grads = torch.autograd.grad(loss, leaves)
    _close_to_max(loss.item(), float(loss_j))
    for (name, k), g in zip([(n, k) for n in sorted(mine) for k in ("a", "b")], grads):
        _close_to_max(g.numpy(), np.asarray(grads_j[name][k]))


def test_train_step_matches_jax_windowed():
    """One train step of both packages (adamw, lr 1e-2) with the windowed
    backend: the loss and the adapters' update."""
    cfg_j, base, batch, spec_j, tree = _lora_case()
    init_j, step_j = j_lora.make_lora_train_step(base, cfg_j, spec_j, learning_rate=1e-2,
                                                 attention_backend="windowed_xla")
    cfg = TransformerConfig.tiny(attention_window_frames=WINDOW)
    init, step = lora.make_lora_train_step(transformer_from_jax(base, cfg, device="cpu"), cfg,
                                           lora.LoRASpec(rank=4, alpha=8.0), learning_rate=1e-2,
                                           attention_backend="windowed")
    rng = jax.random.PRNGKey(100)
    ts, noise = _jax_draws(rng, batch["video_latents"].shape)
    lj = jax.tree.map(jnp.asarray, tree)
    lj, _, loss_j = step_j(lj, init_j(lj), {k: jnp.asarray(v) for k, v in batch.items()}, rng)
    mine = lora_from_jax(tree, device="cpu")
    mine, _, loss = step(mine, init(mine), {k: t(v) for k, v in batch.items()}, timesteps=ts, noise=noise)
    _close_to_max(loss.item(), float(loss_j))
    for target in tree:
        for k in ("a", "b"):
            want = np.asarray(lj[target][k]) - tree[target][k]
            got = mine[target][k].detach().numpy() - tree[target][k]
            assert np.linalg.norm(got - want) <= 1e-3 * max(np.linalg.norm(want), 1e-12), (target, k)


def test_config_window_default_matches_jax():
    assert TransformerConfig().attention_window_frames == JTransformerConfig().attention_window_frames == 2
    assert dataclasses.replace(TransformerConfig.tiny(), attention_window_frames=1).attention_window_frames == 1
