"""A tiny ``S2VPipeline.generate`` on the JAX package and on the port, on the
same weights carried across: 2 DDIM steps with batched CFG, then the VAE
decode.  Latents, ref latents and prompt embeddings are injected (the two
packages draw different random numbers), or the prompt goes through T5."""

import numpy as np
import jax
import pytest

from _torch_parity import FRAME_ATOL, LATENT_ATOL, rand, t, tiny_pipelines


@pytest.fixture(scope="module")
def pipelines():
    return tiny_pipelines()


def _inputs():
    latents = rand(1, 3, 4, 4, 4, seed=10)
    ref = rand(1, 1, 4, 4, 4, seed=11)
    embeds = rand(2, 16, 32, seed=12)
    return latents, ref, embeds


def _run_both(jax_pipe, port, **kw):
    jnp = jax.numpy
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    tkw = {k: (t(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    common = dict(height=32, width=32, num_frames=9, num_inference_steps=2, guidance_scale=6.0)
    lat_j = np.asarray(jax_pipe.generate(output_type="latent", **common, **jkw))
    lat_t = port.generate(output_type="latent", **common, **tkw)
    return lat_j, lat_t, common, tkw


def test_generate_with_injected_embeddings(pipelines):
    jax_pipe, port = pipelines
    latents, ref, embeds = _inputs()
    lat_j, lat_t, common, tkw = _run_both(jax_pipe, port, latents=latents, ref_latents=ref, prompt_embeds=embeds)
    assert lat_t.shape == (1, 3, 4, 4, 4)
    np.testing.assert_allclose(lat_t.numpy(), lat_j, atol=LATENT_ATOL, rtol=1e-4)
    frames_j = jax_pipe.decode_latents(jax.numpy.asarray(lat_j))
    frames_t = port.generate(output_type="np", **common, **tkw)
    assert frames_t.shape == (1, 9, 32, 32, 3) and frames_t.min() >= 0 and frames_t.max() <= 1
    np.testing.assert_allclose(frames_t, frames_j, atol=FRAME_ATOL)
    assert sorted(port.timings) == ["decode_s", "denoise_step_s"] and len(port.timings["denoise_step_s"]) == 2


def test_generate_sequential_cfg(pipelines):
    """uncond and cond as two B forwards: the same math as batched CFG."""
    jax_pipe, port = pipelines
    latents, ref, embeds = _inputs()
    lat_j, lat_t, _, _ = _run_both(jax_pipe, port, latents=latents, ref_latents=ref, prompt_embeds=embeds,
                                   cfg_mode="sequential")
    np.testing.assert_allclose(lat_t.numpy(), lat_j, atol=LATENT_ATOL, rtol=1e-4)


def test_generate_through_encode_prompt(pipelines):
    jax_pipe, port = pipelines
    latents, ref, _ = _inputs()
    lat_j, lat_t, _, _ = _run_both(jax_pipe, port, prompt="a pig walking", negative_prompt="blurry",
                                   latents=latents, ref_latents=ref)
    np.testing.assert_allclose(lat_t.numpy(), lat_j, atol=LATENT_ATOL, rtol=1e-4)
    emb_j = np.asarray(jax_pipe.encode_prompt("a pig walking", "blurry"))
    emb_t = port.encode_prompt("a pig walking", "blurry")
    np.testing.assert_allclose(emb_t.numpy(), emb_j, atol=1e-4, rtol=1e-4)
    assert ("blurry", 16) in port._prompt_embed_cache


def test_generate_from_ref_image_is_seeded(pipelines):
    """The port's own randomness: same seed, same clip; finite, in [0, 1]."""
    _, port = pipelines
    img = np.clip(rand(32, 32, 3, seed=13) * 0.5, -1, 1)
    kw = dict(prompt_embeds=t(rand(2, 16, 32, seed=12)), ref_image=img, height=32, width=32,
              num_frames=9, num_inference_steps=2)
    a = port.generate(seed=7, **kw)
    b = port.generate(seed=7, **kw)
    c = port.generate(seed=8, **kw)
    assert a.shape == (1, 9, 32, 32, 3) and np.isfinite(a).all()
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    assert "encode_ref_s" in port.timings


@pytest.mark.parametrize(
    "kw",
    [
        dict(prompt="x", prompt_embeds=np.zeros((2, 16, 32), np.float32)),
        dict(),
        dict(prompt_embeds=np.zeros((2, 16, 32), np.float32), negative_prompt="y"),
        dict(prompt="x", height=30),
        dict(prompt="x", num_inference_steps=0),
        dict(prompt="x", output_type="gif"),
        dict(prompt=["x", 3]),
    ],
    ids=["prompt_and_embeds", "no_prompt", "negative_with_embeds", "bad_height", "zero_steps", "output_type", "prompt_list"],
)
def test_check_inputs(pipelines, kw):
    _, port = pipelines
    kw = {k: (t(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    kw.setdefault("height", 32)
    with pytest.raises(ValueError):
        port.generate(width=32, num_frames=9, ref_latents=t(rand(1, 1, 4, 4, 4)), **kw)
