"""The decode's memory gate for resident serving (``decode_latents``): the
route by free device bytes (injected), the quarter-tile decode against the
JAX package's, and the retry after running out of memory."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from _torch_parity import FRAME_ATOL, rand, t, tiny_pipelines
from s2v_tpu.models import vae as j_vae
from s2v_torch.pipelines import s2v


@pytest.fixture(scope="module")
def pipelines():
    return tiny_pipelines()


@pytest.fixture
def port(pipelines, monkeypatch):
    """The port's tiny pipeline with every ``vae_decode`` call recorded as
    its route: untiled, tiled (the VAE's own tile size) or lean (the
    quarter-size tiles' sample size)."""
    pipe = pipelines[1]
    monkeypatch.setattr(pipe, "_decode_lean", False)
    routes, real = [], s2v.vae_decode

    def recording(params, cfg, z, use_tiling=True, use_slicing=True):
        lean = cfg.sample_height != pipe.vae_cfg.sample_height
        routes.append("lean" if lean else "tiled" if use_tiling else "untiled")
        return real(params, cfg, z, use_tiling=use_tiling, use_slicing=use_slicing)

    monkeypatch.setattr(s2v, "vae_decode", recording)
    pipe.routes = routes
    return pipe


@pytest.mark.parametrize("free_gb,route", [(6.0, "untiled"), (4.0, "tiled"), (2.0, "lean")])
def test_route_by_free_device_bytes(port, monkeypatch, free_gb, route):
    monkeypatch.setattr(port, "_device_free_bytes", lambda: free_gb * 1e9)
    frames = port.decode_latents(t(rand(1, 3, 4, 4, 4, seed=1)))
    assert frames.shape == (1, 9, 32, 32, 3) and np.isfinite(frames).all()
    assert port.routes == [route]
    assert port._decode_lean == (route == "lean")  # only the lean route sticks


def test_no_gate_on_the_cpu(port):
    assert port._device_free_bytes() is None
    port.decode_latents(t(rand(1, 3, 4, 4, 4, seed=1)))
    assert port.routes == ["untiled"]


def test_lean_tiles_match_jax_tiled_decode(pipelines):
    """The quarter-tile decode is the tiled decode at the rounded tile size
    (the tiny VAE's: 6 x 5 latent, sample 96 x 80): equal to the JAX
    package's ``vae_decode`` at that size, on a latent the tiles cut."""
    jax_pipe, port = pipelines
    z = rand(1, 2, 12, 12, 4, seed=2)
    got = port._decode_lean_tiles(t(z))
    lean_cfg = dataclasses.replace(jax_pipe.vae_cfg, sample_height=96, sample_width=80)
    want = np.asarray(j_vae.vae_decode(jax_pipe.vae_params, lean_cfg, jnp.asarray(z), use_tiling=True))
    assert got.shape == want.shape == (1, 8, 96, 96, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=FRAME_ATOL)
    untiled = s2v.vae_decode(port.vae_params, port.vae_cfg, t(z), use_tiling=False)
    assert not torch.allclose(got, untiled, atol=1e-3)  # the tiles did cut the frame


def test_lean_tiles_cover_the_frame_at_480x720(pipelines, monkeypatch):
    """At the CogVideoX VAE's tile geometry (sample 480 x 720) the rounded
    12 x 20 latent tiles give the whole 480 x 720 frame; the JAX package's
    halved 15 x 22 tiles give 496 x 760 (ROADMAP C.13)."""
    jax_pipe, port = pipelines
    z = rand(1, 1, 60, 90, 4, seed=4)
    monkeypatch.setattr(port, "vae_cfg", dataclasses.replace(port.vae_cfg, sample_height=480, sample_width=720))
    assert port._decode_lean_tiles(t(z)).shape == (1, 1, 480, 720, 3)
    monkeypatch.setattr(jax_pipe, "vae_cfg", dataclasses.replace(jax_pipe.vae_cfg, sample_height=480,
                                                                 sample_width=720))
    assert jax.eval_shape(jax_pipe._decode_lean_tiles, jnp.asarray(z)).shape == (1, 1, 496, 760, 3)


def test_out_of_memory_falls_to_lean_tiles_once(port, monkeypatch):
    real = s2v.vae_decode
    attempts = []

    def failing_once(params, cfg, z, use_tiling=True, use_slicing=True):
        attempts.append(use_tiling)
        if len(attempts) == 1:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory (injected)")
        return real(params, cfg, z, use_tiling=use_tiling, use_slicing=use_slicing)

    monkeypatch.setattr(s2v, "vae_decode", failing_once)
    z = t(rand(1, 3, 4, 4, 4, seed=3))
    frames = port.decode_latents(z)
    assert frames.shape == (1, 9, 32, 32, 3) and np.isfinite(frames).all()
    assert attempts == [False, True] and port._decode_lean
    # the next request goes to the lean tiles directly, with the same frames
    np.testing.assert_array_equal(port.decode_latents(z), frames)
    assert attempts == [False, True, True]


def test_other_errors_are_not_retried(port, monkeypatch):
    def broken(*args, **kwargs):
        raise RuntimeError("not a memory error")

    monkeypatch.setattr(s2v, "vae_decode", broken)
    with pytest.raises(RuntimeError, match="not a memory error"):
        port.decode_latents(t(rand(1, 3, 4, 4, 4, seed=3)))
    assert not port._decode_lean
