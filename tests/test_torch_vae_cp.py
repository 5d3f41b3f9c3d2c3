"""The port's context-parallel VAE (``s2v_torch/parallel/vae_temporal.py``)
on 2 gloo ranks: the uniform decode (4 latent frames, 2 chunks), the
canonical decode (5 latent frames: one chunk after the odd first one, so
rank 1 idles; 7: two), and the encode (16 frames, 2 chunks), against the
JAX package's ``sharded_vae_decode``, ``sharded_vae_decode_canonical`` and
``sharded_vae_encode`` on 2 virtual CPU devices and against the port's own
streaming VAE; the canonical decode equals the streaming decode bit for
bit.  The ranks run in spawned processes (``tests/_torch_sp_worker.py``)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_parity import perturb, rand, t
from _torch_sp_worker import run_ranks
from s2v_tpu.config import VAEConfig as JVAEConfig
from s2v_tpu.models.vae import init_vae_params
from s2v_tpu.parallel import vae_temporal as j_vt
from s2v_tpu.parallel.sharding import make_mesh
from s2v_torch.config import VAEConfig
from s2v_torch.loaders.jax_params import vae_from_jax
from s2v_torch.models.vae import vae_decode, vae_encode

# the JAX package's tolerance for its sharded VAE (tests/test_parallel.py:143-175)
ATOL, RTOL = 2e-5, 1e-4
CANONICAL = {"canonical_5": 5, "canonical_7": 7, "canonical_13": 13}


@functools.lru_cache(maxsize=None)
def _case():
    cfg_j = JVAEConfig.tiny()
    vp = perturb(init_vae_params(jax.random.PRNGKey(0), cfg_j), seed=5, scale=0.05)
    c = cfg_j.latent_channels
    latents = {"uniform": rand(1, 4, 4, 4, c, seed=1),
               **{name: rand(1, n, 4, 4, c, seed=n) for name, n in CANONICAL.items()}}
    pixels = rand(1, 16, 32, 32, 3, seed=2)
    return cfg_j, vp, latents, pixels


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    _, vp, latents, pixels = _case()
    return run_ranks(2, {"vae": ("vae", dict(vp=vp, latents=latents, pixels=pixels))},
                     tmp_path_factory.mktemp("vae_cp"), timeout_s=120)


@functools.lru_cache(maxsize=None)
def _jax(name):
    cfg_j, vp, latents, pixels = _case()
    mesh = make_mesh({"seq": 2}, jax.devices()[:2])
    params = jax.tree.map(jnp.asarray, vp)
    if name == "encode":
        return np.asarray(j_vt.sharded_vae_encode(params, cfg_j, jnp.asarray(pixels), mesh))
    fn = j_vt.sharded_vae_decode if name == "uniform" else j_vt.sharded_vae_decode_canonical
    return np.asarray(fn(params, cfg_j, jnp.asarray(latents[name]), mesh))


def _streaming(name):
    """The port's one-process VAE on the same input (the streaming decode
    with the uniform schedule of 2-frame chunks is the default schedule at
    4 latent frames)."""
    _, vp, latents, pixels = _case()
    cfg = VAEConfig.tiny()
    params = vae_from_jax(vp, cfg, device="cpu")
    if name == "encode":
        return vae_encode(params, cfg, t(pixels), use_tiling=False).numpy()
    return vae_decode(params, cfg, t(latents[name]), use_tiling=False).numpy()


@pytest.mark.parametrize("name", ["uniform", "encode"])
def test_uniform_chunks_match_jax_and_streaming(ranks, name):
    for rank, res in enumerate(ranks):
        got = res["vae"][name]
        np.testing.assert_allclose(got, _jax(name), atol=ATOL, rtol=RTOL, err_msg=f"rank {rank}")
        np.testing.assert_allclose(got, _streaming(name), atol=ATOL, rtol=RTOL, err_msg=f"rank {rank}")


@pytest.mark.parametrize("name", ["canonical_5", "canonical_7"])
def test_canonical_decode_equals_streaming_and_matches_jax(ranks, name):
    want = _streaming(name)
    for rank, res in enumerate(ranks):
        got = res["vae"][name]
        assert got.shape == want.shape == (1, 4 * (CANONICAL[name] - 1) + 1, 32, 32, 3)
        assert np.array_equal(got, want), f"rank {rank}: max diff {np.abs(got - want).max()}"
        np.testing.assert_allclose(got, _jax(name), atol=ATOL, rtol=RTOL, err_msg=f"rank {rank}")


def test_canonical_decode_needs_a_rank_per_chunk(ranks):
    """13 latent frames: 5 uniform chunks after the first, more than 2 ranks."""
    for res in ranks:
        assert "needs ring >= 5 chunks" in res["vae"]["canonical_13"]


def test_ranks_hold_the_same_frames(ranks):
    for key, x in ranks[1]["vae"].items():
        assert np.array_equal(np.asarray(x), np.asarray(ranks[0]["vae"][key])), key
