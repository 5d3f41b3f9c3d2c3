"""The pipeline variants (t2v, i2v, fun-control, v2v), the denoise loop's
``cond_latents`` and ``truncate``, and the disentangled ``generate``, each
held against the JAX package on the tiny pipelines, fp32 on both sides.

The variants draw through ``pipe.variant_noise``; here it hands the port
the JAX package's own draws (``jax.random.normal`` on the keys each JAX
variant splits from its seed), so whole functions are compared."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from _torch_parity import rand, t, tiny_pipelines, write_tiny_snapshot
from s2v_tpu.pipelines import variants as jv
from s2v_tpu.pipelines.denoise import DenoiseSchedule as JDenoiseSchedule
from s2v_tpu.pipelines.denoise import denoise as j_denoise
from s2v_tpu.pipelines.s2v import S2VPipeline as JS2VPipeline
from s2v_torch.config import SchedulerConfig
from s2v_torch.pipelines import generate_fun_control, generate_i2v, generate_t2v, generate_v2v
from s2v_torch.pipelines.denoise import DenoiseSchedule, denoise
from s2v_torch.pipelines.s2v import S2VPipeline
from s2v_torch.pipelines.variants import VariantNoise

# fp32 through 2 DiT blocks x 2-3 steps (and the VAE encode of the
# condition); latents are O(1)
ATOL, RTOL = 1e-4, 1e-4
# frames in [0, 1] after the VAE decode
FRAME_ATOL = 2e-4
PROMPT = "a pig walking"


def _keys(seed, names):
    """The JAX variant's keys by the port's draw names, in its split order."""
    keys = jax.random.split(jax.random.PRNGKey(seed), len(names)) if len(names) > 1 else [jax.random.PRNGKey(seed)]
    return dict(zip(names, keys))


def _jax_noise(keys):
    def noise(name, shape):
        return t(np.asarray(jax.random.normal(keys[name], tuple(shape), jnp.float32)))
    return noise


def _close(got, want, atol=ATOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=RTOL)


@pytest.fixture(scope="module")
def rope_pipes():
    return tiny_pipelines()


@pytest.fixture(scope="module")
def i2v_pipes():
    # an I2V checkpoint patch-embeds (noise | condition): twice the VAE's 4 latent channels
    return tiny_pipelines(in_channels=8, out_channels=4)


def _image(seed, h=32, w=32):
    return np.clip(np.random.RandomState(seed).randn(h, w, 3).astype(np.float32) * 0.5, -1, 1)


def _video(seed, frames=9):
    return np.clip(np.random.RandomState(seed).randn(frames, 32, 32, 3).astype(np.float32) * 0.5, -1, 1)


@pytest.mark.parametrize("use_dpm", [False, True], ids=["ddim", "dpm"])
@pytest.mark.parametrize("strength", [0.3, 0.6, 0.8, 1.0])
def test_truncate_matches_jax(use_dpm, strength):
    from s2v_tpu.config import SchedulerConfig as JSchedulerConfig

    want = JDenoiseSchedule.create(JSchedulerConfig(), 10, 6.0, True, use_dpm).truncate(strength)
    got = DenoiseSchedule.create(SchedulerConfig(), 10, 6.0, True, use_dpm).truncate(strength)
    for name in ("timesteps", "alpha_t", "alpha_prev", "guidance"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
    if use_dpm:
        assert got.dpm_mults["has_back"][0] == 0.0
        for k in want.dpm_mults:
            np.testing.assert_array_equal(got.dpm_mults[k], want.dpm_mults[k], err_msg=k)


@pytest.mark.parametrize("cfg_mode", ["batched", "sequential"])
def test_denoise_with_cond_latents_matches_jax(i2v_pipes, cfg_mode):
    """The condition concatenated on the channel axis every step, doubled
    for the batched CFG forward."""
    jax_pipe, port = i2v_pipes
    latents, ref = rand(1, 3, 4, 4, 4, seed=20), rand(1, 1, 4, 4, 8, seed=21)
    cond, embeds = rand(1, 3, 4, 4, 4, seed=22), rand(2, 16, 32, seed=23)
    cs, sn = jax_pipe.prepare_rope(32, 32, 3)
    schedule_j = JDenoiseSchedule.create(jax_pipe.scheduler_cfg, 2, 6.0, False)
    want = j_denoise(jax_pipe.transformer_params, jax_pipe.transformer_cfg, schedule_j, jnp.asarray(latents),
                     jnp.asarray(ref), jnp.asarray(embeds), cs, sn, attention_backend="xla", cfg_mode=cfg_mode,
                     cond_latents=jnp.asarray(cond))
    rc, rs = port.prepare_rope(32, 32, 3)
    got = denoise(port.transformer_params, port.transformer_cfg, DenoiseSchedule.create(port.scheduler_cfg, 2, 6.0),
                  t(latents), t(ref), t(embeds), rc, rs, cfg_mode=cfg_mode, cond_latents=t(cond))
    _close(got, want)


def _port_run(port, keys, fn, *args, **kw):
    port.variant_noise = _jax_noise(keys)
    try:
        return fn(port, *args, **kw)
    finally:
        port.variant_noise = None


STEPS = dict(num_inference_steps=2, guidance_scale=6.0, seed=5)


@pytest.mark.parametrize("output_type", ["latent", "np"])
def test_t2v_matches_jax(rope_pipes, output_type):
    jax_pipe, port = rope_pipes
    kw = dict(height=32, width=32, num_frames=9, **STEPS, output_type=output_type)
    want = jv.generate_t2v(jax_pipe, PROMPT, **kw)
    got = _port_run(port, _keys(5, ["latents"]), generate_t2v, PROMPT, **kw)
    _close(got, want, ATOL if output_type == "latent" else FRAME_ATOL)
    if output_type == "np":
        assert got.shape == (1, 9, 32, 32, 3) and got.min() >= 0 and got.max() <= 1
        assert sorted(port.timings) == ["decode_s", "denoise_step_s", "encode_prompt_s"]


def test_i2v_matches_jax(i2v_pipes):
    jax_pipe, port = i2v_pipes
    kw = dict(height=32, width=32, num_frames=9, **STEPS, output_type="latent")
    image = _image(30)
    want = jv.generate_i2v(jax_pipe, PROMPT, image, **kw)
    got = _port_run(port, _keys(5, ["latents", "cond", "ref"]), generate_i2v, PROMPT, image, **kw)
    assert got.shape == (1, 3, 4, 4, 4)
    _close(got, want)


def test_fun_control_matches_jax(i2v_pipes):
    jax_pipe, port = i2v_pipes
    control = _video(31)
    want = jv.generate_fun_control(jax_pipe, PROMPT, control, **STEPS, output_type="latent")
    got = _port_run(port, _keys(5, ["latents", "cond", "ref"]), generate_fun_control, PROMPT, control, **STEPS,
                    output_type="latent")
    _close(got, want)


@pytest.mark.parametrize("strength", [0.8, 1.0])
def test_v2v_matches_jax(rope_pipes, strength):
    jax_pipe, port = rope_pipes
    video = _video(32)
    kw = dict(strength=strength, num_inference_steps=3, guidance_scale=6.0, seed=5, output_type="latent")
    want = jv.generate_v2v(jax_pipe, PROMPT, video, **kw)
    k_init, k_ref = jax.random.split(jax.random.PRNGKey(5))
    k_s, k_n = jax.random.split(k_init)
    keys = {"video_posterior": k_s, "video_noise": k_n, "ref": k_ref}
    got = _port_run(port, keys, generate_v2v, PROMPT, video, **kw)
    _close(got, want)
    assert len(port.timings["denoise_step_s"]) == int(3 * strength)


def test_v2v_on_a_sincos_model_adds_the_generate_table():
    """C.18: JAX's v2v passes no table, so on a sincos model it runs without
    positions; the port adds the table JAX's generate builds, held here to
    JAX's denoise with that table on the same initial latents."""
    from s2v_tpu.ops.sincos import joint_text_video_pos_embedding

    jax_pipe, port = tiny_pipelines(use_rotary_positional_embeddings=False)
    video = _video(33)
    k_init, k_ref = jax.random.split(jax.random.PRNGKey(5))
    schedule = JDenoiseSchedule.create(jax_pipe.scheduler_cfg, 3, 6.0, False).truncate(0.8)
    init = jv.prepare_v2v_latents(jax_pipe, jnp.asarray(video)[None], schedule, k_init)
    ref = jax_pipe.encode_ref_image(video[0], k_ref)
    cfg = jax_pipe.transformer_cfg
    table = joint_text_video_pos_embedding(cfg.inner_dim, 4, 4, 9, cfg.patch_size, 4, cfg.max_text_seq_length,
                                           cfg.spatial_interpolation_scale, cfg.temporal_interpolation_scale)
    want = j_denoise(jax_pipe.transformer_params, cfg, schedule, init, ref, jax_pipe.encode_prompt(PROMPT),
                     None, None, attention_backend="xla", pos_embedding=jnp.asarray(table))
    k_s, k_n = jax.random.split(k_init)
    got = _port_run(port, {"video_posterior": k_s, "video_noise": k_n, "ref": k_ref}, generate_v2v, PROMPT, video,
                    strength=0.8, num_inference_steps=3, guidance_scale=6.0, seed=5, output_type="latent")
    _close(got, want)
    with pytest.raises(ValueError, match="static positional embeddings"):
        generate_v2v(port, PROMPT, _video(34, frames=13), num_inference_steps=2, output_type="latent")


def test_default_noise_is_seeded_per_name(rope_pipes):
    _, port = rope_pipes
    a, b = VariantNoise(3), VariantNoise(3)
    assert torch.equal(a("latents", (2, 3)), b("latents", (2, 3)))
    assert not torch.equal(a("latents", (2, 3)), a("ref", (2, 3)))
    assert not torch.equal(a("latents", (2, 3)), VariantNoise(4)("latents", (2, 3)))
    kw = dict(height=32, width=32, num_frames=9, num_inference_steps=1, seed=9, output_type="latent")
    assert torch.equal(generate_t2v(port, PROMPT, **kw), generate_t2v(port, PROMPT, **kw))


@pytest.fixture(scope="module")
def snapshot(tmp_path_factory):
    return write_tiny_snapshot(tmp_path_factory.mktemp("disent"))


def test_disentangled_generate_matches_jax(snapshot):
    """from_pretrained(disentangled_modulation=True) keeps the pre-merge
    adaLN linears (video and text modulated by them, the ref stream by the
    LoRA-merged ones); generate matches JAX's on the same snapshot and
    LoRA, and differs from the merged modulation."""
    snap, lora = snapshot
    inputs = dict(latents=rand(1, 3, 4, 4, 4, seed=40), ref_latents=rand(1, 1, 4, 4, 4, seed=41),
                  prompt_embeds=rand(2, 16, 32, seed=42))
    common = dict(height=32, width=32, num_frames=9, num_inference_steps=2, guidance_scale=6.0, output_type="latent")
    jpipe = JS2VPipeline.from_pretrained(snap, lora_checkpoint=lora, dtype=jnp.float32, disentangled_modulation=True)
    want = jpipe.generate(**{k: jnp.asarray(v) for k, v in inputs.items()}, **common)
    pipe = S2VPipeline.from_pretrained(snap, lora_checkpoint=lora, dtype=torch.float32, device="cpu",
                                       disentangled_modulation=True)
    assert pipe.transformer_cfg.disentangled_modulation
    block = pipe.transformer_params["blocks"][1]["norm1"]
    assert not torch.equal(block["base_linear"]["weight"], block["linear"]["weight"])
    got = pipe.generate(**{k: t(v) for k, v in inputs.items()}, **common)
    _close(got, want)
    merged = S2VPipeline.from_pretrained(snap, lora_checkpoint=lora, dtype=torch.float32, device="cpu")
    assert np.abs(merged.generate(**{k: t(v) for k, v in inputs.items()}, **common).numpy() - got.numpy()).max() > 1e-3
    # a swap re-reads the base with its pre-merge linears: back to the same latents
    pipe.load_lora(None)
    pipe.load_lora(lora)
    assert "base_linear" in pipe.transformer_params["blocks"][0]["norm2"]
    _close(pipe.generate(**{k: t(v) for k, v in inputs.items()}, **common), want)
