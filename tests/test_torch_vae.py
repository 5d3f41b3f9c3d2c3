"""The port's tiny VAE against the JAX package's: single- and multi-chunk
streamed encode/decode, a tiled encode and decode, and the posterior sample."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from _torch_parity import perturb, rand, t
from s2v_tpu.config import VAEConfig as JVAEConfig
from s2v_tpu.models import vae as j_vae
from s2v_torch.config import VAEConfig
from s2v_torch.loaders.jax_params import vae_from_jax
from s2v_torch.models import vae

# fp32 through ~20 convs and group norms on O(1) activations
ATOL, RTOL = 2e-4, 2e-4


def _params(**cfg_kw):
    params = perturb(j_vae.init_vae_params(jax.random.PRNGKey(0), JVAEConfig.tiny(**cfg_kw)), seed=5, scale=0.05)
    cfg = VAEConfig.tiny(**cfg_kw)
    return params, cfg, vae_from_jax(params, cfg, device="cpu")


@pytest.mark.parametrize("frames", [1, 9, 17], ids=["image", "one_chunk", "two_chunks"])
def test_encode_matches_jax(frames):
    params, cfg, params_t = _params()
    x = rand(1, frames, 32, 32, 3, seed=frames)
    want = j_vae.vae_encode(params, JVAEConfig.tiny(), jnp.asarray(x), use_tiling=False)
    got = vae.vae_encode(params_t, cfg, t(x), use_tiling=False)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("latent_frames", [3, 5], ids=["one_chunk", "streamed"])
def test_decode_matches_jax(latent_frames):
    """3 latent frames decode as one chunk (the remainder folds into it); 5
    stream as chunks (0,3),(3,5) with the conv caches carried between them."""
    params, cfg, params_t = _params()
    z = rand(2, latent_frames, 4, 4, cfg.latent_channels, seed=latent_frames)
    want = j_vae.vae_decode(params, JVAEConfig.tiny(), jnp.asarray(z), use_tiling=False)
    got = vae.vae_decode(params_t, cfg, t(z), use_tiling=False)
    assert got.shape == want.shape == (2, 4 * latent_frames - 3, 32, 32, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


def test_tiled_decode_and_encode_match_jax():
    kw = dict(sample_height=96, sample_width=80)
    params, cfg, params_t = _params(**kw)
    z = rand(1, 3, 12, 10, cfg.latent_channels, seed=11)
    want = j_vae.vae_decode(params, JVAEConfig.tiny(**kw), jnp.asarray(z), use_tiling=True)
    got = vae.vae_decode(params_t, cfg, t(z), use_tiling=True)
    assert got.shape == (1, 9, 96, 80, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)
    x = rand(1, 1, 96, 80, 3, seed=12)
    want = j_vae.vae_encode(params, JVAEConfig.tiny(**kw), jnp.asarray(x), use_tiling=True)
    got = vae.vae_encode(params_t, cfg, t(x), use_tiling=True)
    assert got.shape == (1, 1, 12, 10, 2 * cfg.latent_channels)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


def test_blend_and_gaussian_sample():
    a, b = rand(1, 2, 8, 8, 3, seed=13), rand(1, 2, 8, 8, 3, seed=14)
    cf = lambda x: t(x).permute(0, 4, 1, 2, 3)  # noqa: E731
    np.testing.assert_allclose(vae.blend_v(cf(a), cf(b), 4).permute(0, 2, 3, 4, 1).numpy(),
                               np.asarray(j_vae.blend_v(jnp.asarray(a), jnp.asarray(b), 4)), atol=1e-6)
    np.testing.assert_allclose(vae.blend_h(cf(a), cf(b), 3).permute(0, 2, 3, 4, 1).numpy(),
                               np.asarray(j_vae.blend_h(jnp.asarray(a), jnp.asarray(b), 3)), atol=1e-6)
    moments, noise = rand(1, 1, 4, 4, 8, seed=15) * 10, rand(1, 1, 4, 4, 4, seed=16)
    for nz in (None, noise):
        want = j_vae.gaussian_sample(jnp.asarray(moments), None if nz is None else jnp.asarray(nz))
        got = vae.gaussian_sample(t(moments), None if nz is None else t(nz))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    assert vae._chunk_bounds(13, 2) == j_vae._chunk_bounds(13, 2)


def test_random_init_matches_jax_structure():
    cfg = VAEConfig.tiny()
    mine = vae.init_vae_params_random(cfg, device="cpu")
    theirs = vae_from_jax(jax.tree.map(np.asarray, j_vae.init_vae_params(jax.random.PRNGKey(0), JVAEConfig.tiny())),
                          cfg, device="cpu")
    shapes = lambda tree: jax.tree.map(lambda a: tuple(a.shape), tree)  # noqa: E731
    assert shapes(mine) == shapes(theirs)
