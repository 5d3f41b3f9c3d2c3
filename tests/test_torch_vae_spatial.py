"""The spatial-tile context-parallel VAE decode (ROADMAP A.9.2,
``s2v_torch/parallel/vae_spatial.py``) on 2 and 4 gloo ranks
(``tests/_torch_sp_worker.py``), against the single-card tiled decode on
each rank and JAX's ``spatial_tiled_decode_cp`` on a seq mesh of virtual
CPU devices; and ``S2VPipeline.decode_latents`` on a ring taking it.

The tiny VAE at sample size 64 tiles 4x4 latents with a stride of 3: a
10x10 latent frame gives 9 full tiles and 7 ragged edge tiles, so 2 ranks
pad the interior list by 1 and 4 ranks by 3.  Tolerance: fp32, the CP
decode equal to the single-card tiled decode bit for bit on every rank (the
same tiles through the same convolutions and blend), and within 1e-5 of
JAX's.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_parity import perturb, rand
from _torch_sp_worker import run_ranks
from s2v_tpu.config import VAEConfig as JVAEConfig
from s2v_tpu.models.vae import init_vae_params
from s2v_tpu.parallel.sharding import make_mesh
from s2v_tpu.parallel.vae_spatial import spatial_cp_supported as j_supported
from s2v_tpu.parallel.vae_spatial import spatial_tiled_decode_cp as j_decode_cp

ATOL = 1e-5
CFG_KW = dict(latent_channels=4, sample_height=64, sample_width=64)
WORLDS = (2, 4)


@functools.lru_cache(maxsize=None)
def _case():
    vp = perturb(init_vae_params(jax.random.PRNGKey(1), JVAEConfig.tiny(**CFG_KW)), seed=2, scale=0.05)
    return vp, rand(1, 2, 10, 10, 4, seed=3)


@functools.lru_cache(maxsize=None)
def _jax(world):
    vp, latents = _case()
    mesh = make_mesh({"seq": world}, jax.devices()[:world])
    cfg = JVAEConfig.tiny(**CFG_KW)
    z = jnp.asarray(latents)
    return j_supported(cfg, z, mesh, "seq"), np.asarray(j_decode_cp(jax.tree.map(jnp.asarray, vp), cfg, z, mesh,
                                                                     "seq"))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    vp, latents = _case()
    return {world: run_ranks(world, {"spatial": ("spatial", dict(vp=vp, latents=latents, cfg_kw=CFG_KW))},
                             tmp_path_factory.mktemp(f"spatial{world}"), timeout_s=180) for world in WORLDS}


@pytest.mark.parametrize("world", WORLDS)
def test_spatial_cp_decode_equals_the_tiled_decode_and_jax(ranks, world):
    supported_j, want = _jax(world)
    for rank, res in enumerate(ranks[world]):
        got = res["spatial"]
        assert got["supported"] and supported_j
        assert got["cp"].shape == got["single"].shape == want.shape
        assert np.array_equal(got["cp"], got["single"]), f"rank {rank}"
        np.testing.assert_allclose(got["cp"], want, atol=ATOL, rtol=0, err_msg=f"rank {rank}")
        assert np.array_equal(got["cp"], ranks[world][0]["spatial"]["cp"])


@pytest.mark.parametrize("world", WORLDS)
def test_decode_latents_on_a_ring_takes_the_spatial_route(ranks, world):
    """``S2VPipeline.decode_latents`` on the ring, above the native size:
    one spatial CP decode, its frames denormalized to [0, 1]."""
    from s2v_torch.utils.video import denormalize_video

    for res in ranks[world]:
        got = res["spatial"]
        assert got["pipeline_cp_calls"] == 1
        # the latents scaled by the VAE factor and back: 1e-5 of rounding
        np.testing.assert_allclose(got["pipeline"], denormalize_video(got["cp"]), atol=1e-5, rtol=0)


def test_spatial_cp_refuses_a_ring_wider_than_the_interior():
    """``spatial_cp_supported`` needs a full tile for each rank, and is off
    in the untiled regime and without a seq dim (meta tensors: metadata only)."""
    import torch

    from s2v_torch.config import VAEConfig
    from s2v_torch.parallel.vae_spatial import _split, spatial_cp_supported

    cfg = VAEConfig.tiny(**CFG_KW)
    full, edge = _split(cfg, 10, 10)
    assert (len(full), len(edge)) == (9, 7)

    class _Mesh:
        mesh_dim_names = ("data",)

    assert not spatial_cp_supported(cfg, torch.empty(1, 2, 10, 10, 4, device="meta"), _Mesh())
    assert not spatial_cp_supported(cfg, torch.empty(1, 2, 10, 10, 4, device="meta"), None)
