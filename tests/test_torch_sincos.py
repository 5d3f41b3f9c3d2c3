"""The 2b family's sincos positions: the port's table against the JAX
package's, the DiT forward with it, ``generate`` on a tiny sincos model
(ROADMAP C.16: the port used to drop the table), the pin of the JAX
package's t2v fault on such a model (C.17) and the LoRA loss with the table
(C.19)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from _torch_parity import perturb, rand, t, tiny_pipelines
from s2v_tpu.config import TransformerConfig as JTransformerConfig
from s2v_tpu.models.transformer import init_transformer_params, transformer_forward as j_forward
from s2v_tpu.ops import sincos as j_sincos
from s2v_tpu.pipelines.denoise import DenoiseSchedule as JDenoiseSchedule
from s2v_tpu.pipelines.denoise import denoise as j_denoise
from s2v_torch.config import TransformerConfig
from s2v_torch.loaders.jax_params import transformer_from_jax
from s2v_torch.models.transformer import transformer_forward
from s2v_torch.ops import sincos
from s2v_torch.pipelines.variants import generate_t2v

# the table: the same float64 numpy arithmetic, rounded to fp32 once
TABLE_ATOL = 1e-6
# fp32 through 2 blocks (x 2 DDIM steps for the pipelines); outputs are O(1)
ATOL, RTOL = 1e-4, 1e-4
SINCOS = dict(use_rotary_positional_embeddings=False)


@pytest.mark.parametrize("dim,h,w,frames,text", [(64, 8, 8, 9, 16), (64, 4, 6, 5, 3), (1920, 60, 90, 49, 226)],
                         ids=["tiny", "ragged", "cogvideox_2b"])
def test_table_matches_jax(dim, h, w, frames, text):
    args = (dim, h, w, frames, 2, 4, text, 1.875, 1.0)
    want = j_sincos.joint_text_video_pos_embedding(*args)
    got = sincos.joint_text_video_pos_embedding(*args)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.abs(got[:text]).max() == 0.0  # the text span gets no position
    np.testing.assert_allclose(got, want, atol=TABLE_ATOL, rtol=0)
    np.testing.assert_allclose(sincos.get_3d_sincos_pos_embed(dim, (w // 2, h // 2), 3, 2.0, 0.5),
                               j_sincos.get_3d_sincos_pos_embed(dim, (w // 2, h // 2), 3, 2.0, 0.5),
                               atol=TABLE_ATOL, rtol=0)


@pytest.mark.parametrize("with_ref", [True, False], ids=["3stream", "no_ref"])
def test_forward_with_pos_embedding_matches_jax(with_ref):
    cfg_j = JTransformerConfig.tiny(**SINCOS)
    params = perturb(init_transformer_params(jax.random.PRNGKey(0), cfg_j), seed=1)
    b, f, h, w = 2, 3, 8, 8
    video = rand(b, f, h, w, cfg_j.in_channels, seed=2)
    ref = rand(b, 1, h, w, cfg_j.in_channels, seed=3) if with_ref else None
    text = rand(b, cfg_j.max_text_seq_length, cfg_j.text_embed_dim, seed=4)
    ts = np.array([999, 500], np.int32)
    table = j_sincos.joint_text_video_pos_embedding(cfg_j.inner_dim, h, w, 4 * (f - 1) + 1, 2, 4,
                                                    cfg_j.max_text_seq_length)
    want = j_forward(params, cfg_j, jnp.asarray(video), None if ref is None else jnp.asarray(ref),
                     jnp.asarray(text), jnp.asarray(ts), pos_embedding=jnp.asarray(table), attention_backend="xla")
    cfg = TransformerConfig.tiny(**SINCOS)
    params_t = transformer_from_jax(params, cfg, device="cpu")
    args = (params_t, cfg, t(video), None if ref is None else t(ref), t(text), torch.from_numpy(ts))
    got = transformer_forward(*args, attention_backend="plain", pos_embedding=t(table))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)
    # the table moves the prediction: dropping it is visible at this tolerance
    without = transformer_forward(*args, attention_backend="plain")
    assert np.abs(without.numpy() - np.asarray(want)).max() > 100 * ATOL


@pytest.fixture(scope="module")
def sincos_pipelines():
    return tiny_pipelines(**SINCOS)


def test_generate_on_a_sincos_model_matches_jax(sincos_pipelines):
    """C.16: the port's generate builds and adds the [text | video] table as
    JAX's does (s2v_tpu/pipelines/s2v.py:990-1003); before, it ran the model
    without positions and returned another clip without an error."""
    jax_pipe, port = sincos_pipelines
    latents, ref, embeds = rand(1, 3, 4, 4, 4, seed=10), rand(1, 1, 4, 4, 4, seed=11), rand(2, 16, 32, seed=12)
    common = dict(height=32, width=32, num_frames=9, num_inference_steps=2, guidance_scale=6.0, output_type="latent")
    want = np.asarray(jax_pipe.generate(latents=jnp.asarray(latents), ref_latents=jnp.asarray(ref),
                                        prompt_embeds=jnp.asarray(embeds), **common))
    got = port.generate(latents=t(latents), ref_latents=t(ref), prompt_embeds=t(embeds), **common)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
    table = port.prepare_pos_embedding(32, 32, 9)
    assert table.shape == (16 + 3 * 2 * 2, 64) and table.dtype == torch.float32
    with pytest.raises(ValueError, match="static positional embeddings"):
        port.generate(latents=t(latents), ref_latents=t(ref), prompt_embeds=t(embeds),
                      **{**common, "num_frames": 13})


def test_jax_t2v_fails_on_sincos_and_the_port_builds_the_generate_table(sincos_pipelines):
    """C.17: JAX's generate_t2v calls joint_text_video_pos_embedding with 4 of
    its 7 positional arguments (s2v_tpu/pipelines/variants.py:107-113) and
    raises TypeError on every sincos model.  The port's t2v builds the table
    as JAX's generate does: held here to JAX's denoise run with that table,
    a zero-width ref stream and the same latents."""
    from s2v_tpu.pipelines.variants import generate_t2v as j_generate_t2v

    jax_pipe, port = sincos_pipelines
    kw = dict(height=32, width=32, num_frames=9, num_inference_steps=2, guidance_scale=6.0, seed=3)
    with pytest.raises(TypeError, match="joint_text_video_pos_embedding"):
        j_generate_t2v(jax_pipe, "a pig", **kw)

    cfg_j = jax_pipe.transformer_cfg
    latents = np.asarray(jax.random.normal(jax.random.PRNGKey(3), (1, 3, 4, 4, 4), jnp.float32))
    table = j_sincos.joint_text_video_pos_embedding(cfg_j.inner_dim, 4, 4, 9, cfg_j.patch_size, 4,
                                                    cfg_j.max_text_seq_length, cfg_j.spatial_interpolation_scale,
                                                    cfg_j.temporal_interpolation_scale)
    schedule = JDenoiseSchedule.create(jax_pipe.scheduler_cfg, 2, 6.0, False)
    want = np.asarray(j_denoise(jax_pipe.transformer_params, cfg_j, schedule, jnp.asarray(latents), None,
                                jax_pipe.encode_prompt("a pig", do_cfg=True), None, None, do_cfg=True,
                                attention_backend="xla", pos_embedding=jnp.asarray(table)))
    port.variant_noise = lambda name, shape: t(latents) if name == "latents" else None
    try:
        got = generate_t2v(port, "a pig", output_type="latent", **kw)
    finally:
        port.variant_noise = None
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


def test_vpred_loss_reads_the_table_from_the_batch():
    """C.19: the JAX package's vpred_loss passes no table, so its 2b LoRA
    training runs without positions.  The port's reads an optional
    ``pos_embedding`` from the batch: held here to the JAX transformer run
    with the table on the same draws, and without the key it is JAX's loss."""
    from s2v_tpu.schedulers import ddim as j_ddim
    from s2v_tpu.config import SchedulerConfig as JSchedulerConfig
    from s2v_tpu.training.full import vpred_loss as j_vpred_loss
    from s2v_torch.training.full import vpred_loss

    cfg_j = JTransformerConfig.tiny(**SINCOS)
    params = perturb(init_transformer_params(jax.random.PRNGKey(0), cfg_j), seed=1)
    alphas = np.asarray(j_ddim.compute_alphas_cumprod(JSchedulerConfig()))
    x0, ref = rand(1, 3, 8, 8, 4, seed=2), rand(1, 1, 8, 8, 4, seed=3)
    text = rand(1, cfg_j.max_text_seq_length, cfg_j.text_embed_dim, seed=4)
    table = j_sincos.joint_text_video_pos_embedding(cfg_j.inner_dim, 8, 8, 9, 2, 4, cfg_j.max_text_seq_length)
    rng = jax.random.PRNGKey(7)
    k_t, k_n = jax.random.split(rng)
    ts = jax.random.randint(k_t, (1,), 0, alphas.shape[0])
    noise = jax.random.normal(k_n, x0.shape, jnp.float32)
    a = jnp.asarray(alphas)[ts][:, None, None, None, None]
    noisy = a ** 0.5 * x0 + (1 - a) ** 0.5 * noise
    target = a ** 0.5 * noise - (1 - a) ** 0.5 * x0
    pred = j_forward(params, cfg_j, noisy, jnp.asarray(ref), jnp.asarray(text), ts, pos_embedding=jnp.asarray(table))
    want = float(jnp.mean(jnp.square(pred - target)))
    cfg = TransformerConfig.tiny(**SINCOS)
    params_t = transformer_from_jax(params, cfg, device="cpu")
    batch = {"video_latents": t(x0), "ref_latents": t(ref), "text_embeds": t(text)}
    hooks = dict(timesteps=torch.from_numpy(np.array(ts)), noise=t(noise))
    got = vpred_loss(params_t, cfg, {**batch, "pos_embedding": t(table)}, torch.from_numpy(alphas), **hooks)
    np.testing.assert_allclose(got.item(), want, rtol=RTOL)
    without = vpred_loss(params_t, cfg, batch, torch.from_numpy(alphas), **hooks)
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    np.testing.assert_allclose(without.item(), float(j_vpred_loss(params, cfg_j, jbatch, jnp.asarray(alphas), rng)),
                               rtol=RTOL)
    assert abs(got.item() - without.item()) > 1e-4 * abs(want)
