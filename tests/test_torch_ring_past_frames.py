"""Rings with more ranks than latent frames (ROADMAP A.9.4): the tiny
``generate`` on a 4-rank ``seq`` ring over gloo (``tests/_torch_sp_worker.py``)
against the JAX package's under ``mesh="sp4"`` on virtual CPU devices.

A 5-frame clip has 2 latent frames, so ranks 2 and 3 hold one dummy frame
each: the exact backends (``flash`` routed to ``sp_allgather``, ``ring``,
``sp_ulysses``) decode the clip, whose 2 latent frames the ring cannot
serve context-parallel, so the decode streams on every rank with JAX's
warning; ``sp_windowed`` (B6/B7's plain versions on such shards) to
latents against JAX's ``windowed_xla``.  A 9-frame clip (3 latent frames,
the trainer's clips under ``--mesh sp4``) through ``sp_allgather``.

Tolerance: fp32, 2e-4 (the sequence-parallel generate tests'); every rank
holds the same result bit for bit.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_parity import perturb, rand
from _torch_sp_worker import run_ranks
from s2v_tpu.config import SchedulerConfig as JSchedulerConfig
from s2v_tpu.config import TransformerConfig as JTransformerConfig
from s2v_tpu.config import VAEConfig as JVAEConfig
from s2v_tpu.models.transformer import init_transformer_params
from s2v_tpu.models.vae import init_vae_params
from s2v_tpu.pipelines.s2v import S2VPipeline as JS2VPipeline

GEN_ATOL, RTOL = 2e-4, 1e-4
RING = 4
# name: (port backend, window, clip frames, output type, JAX backend)
CASES = {
    "flash": ("flash", 1, 5, "np", "sp_allgather"),
    "ring": ("ring", 1, 5, "np", "sp_allgather"),
    "sp_ulysses": ("sp_ulysses", 1, 5, "np", "sp_allgather"),
    "sp_windowed": ("sp_windowed", 1, 5, "latent", "windowed_xla"),
    "sp_allgather_9": ("sp_allgather", 1, 9, "latent", "sp_allgather"),
}


@functools.lru_cache(maxsize=None)
def _weights():
    tcfg_j = JTransformerConfig.tiny()
    vcfg_j = JVAEConfig.tiny(latent_channels=4, sample_height=64, sample_width=64)
    tp = perturb(init_transformer_params(jax.random.PRNGKey(0), tcfg_j), seed=1, scale=0.05)
    vp = perturb(init_vae_params(jax.random.PRNGKey(1), vcfg_j), seed=2, scale=0.05)
    return tcfg_j, vcfg_j, tp, vp


def _inputs(frames, output_type):
    common = dict(height=32, width=32, num_frames=frames, num_inference_steps=2, guidance_scale=6.0,
                  output_type=output_type)
    f_lat = (frames - 1) // 4 + 1
    return rand(1, f_lat, 4, 4, 4, seed=10), rand(1, 1, 4, 4, 4, seed=11), rand(2, 16, 32, seed=12), common


@functools.lru_cache(maxsize=None)
def _jax(name):
    _, window, frames, output_type, jax_backend = CASES[name]
    tcfg_j, vcfg_j, tp, vp = _weights()
    pipe = JS2VPipeline(transformer_params=jax.tree.map(jnp.asarray, tp), transformer_cfg=tcfg_j,
                        vae_params=jax.tree.map(jnp.asarray, vp), vae_cfg=vcfg_j, scheduler_cfg=JSchedulerConfig())
    pipe.set_mesh(f"sp{RING}")
    pipe.set_attention(jax_backend, window)
    latents, ref, embeds, common = _inputs(frames, output_type)
    return np.asarray(pipe.generate(latents=jnp.asarray(latents), ref_latents=jnp.asarray(ref),
                                    prompt_embeds=jnp.asarray(embeds), **common))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    _, _, tp, vp = _weights()
    cases = {name: ("generate", dict(tp=tp, vp=vp, inputs=_inputs(frames, output_type), window=window,
                                     backend=backend))
             for name, (backend, window, frames, output_type, _) in CASES.items()}
    return run_ranks(RING, cases, tmp_path_factory.mktemp("ring_past_frames"), timeout_s=240)


@pytest.mark.parametrize("name", list(CASES))
def test_ring_past_the_frame_count_matches_jax(ranks, name):
    want = _jax(name)
    for rank, res in enumerate(ranks):
        got = res[name]["latents"]
        assert got.shape == want.shape, (name, got.shape, want.shape)
        np.testing.assert_allclose(got, want, atol=GEN_ATOL, rtol=RTOL, err_msg=f"{name} rank {rank}")
        assert np.array_equal(got, ranks[0][name]["latents"]), (name, rank)


def test_two_latent_frames_decode_streams_with_jax_warning(ranks):
    """2 latent frames on a ring of 4: neither uniform chunks nor the
    canonical schedule fit, so every rank streams the decode and says so in
    JAX's words."""
    for res in ranks:
        warnings = res["flash"]["warnings"]
        assert any("seq mesh (ring=4) cannot serve the canonical 0-chunk decode schedule for 2 latent frames; "
                   "falling back to the single-device canonical streaming decode" in w for w in warnings), warnings
