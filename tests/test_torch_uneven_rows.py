"""``generate`` on a ``data`` mesh dim that does not divide a forward's rows
(ROADMAP C.32), over gloo ranks (``tests/_torch_mesh_worker.py``), against
the JAX package's ``generate`` under the same mesh on virtual CPU devices
(GSPMD shards an uneven batch).

The four cases of ROADMAP C.32 and one more: ``dp4`` at the defaults (one
prompt's batched CFG, 2 rows over 4 ranks), ``dp2`` under cfg-skip (1 row
on a skipped step), under ``cfg_mode="sequential"`` (1 row a forward) and
under ``dp2,tp2`` with cfg-skip, and ``dp4`` under cfg-skip (1 row over 4
ranks).  The port pads a forward's rows to a multiple of the dim with
dummy rows and drops them after the gather; under autograd it still
refuses (the trainer keeps JAX's ``train_batch_size % data`` refusal).

Tolerance: fp32, the latents after 2 steps within 1e-4 of JAX's (JAX came
within 2.4e-6 of one device on these cases); every rank holds the same
latents bit for bit.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_mesh_worker import run_mesh_ranks
from _torch_parity import perturb, rand
from s2v_tpu.config import SchedulerConfig as JSchedulerConfig
from s2v_tpu.config import TransformerConfig as JTransformerConfig
from s2v_tpu.config import VAEConfig as JVAEConfig
from s2v_tpu.models.transformer import init_transformer_params
from s2v_tpu.models.vae import init_vae_params
from s2v_tpu.pipelines.s2v import S2VPipeline as JS2VPipeline

ATOL, RTOL = 1e-4, 1e-4
SKIP = dict(cfg_skip_threshold=10.0, use_dynamic_cfg=True)
# name: (mesh spec, generate options)
CASES = {
    "dp4_defaults": ("dp4", {}),
    "dp2_cfg_skip": ("dp2", SKIP),
    "dp2_sequential": ("dp2", dict(cfg_mode="sequential")),
    "dp2_tp2_cfg_skip": ("dp2,tp2", SKIP),
    "dp4_cfg_skip": ("dp4", SKIP),
}


def _size(spec):
    return int(np.prod([int(part[2:]) for part in spec.split(",")]))


@functools.lru_cache(maxsize=None)
def _pipeline_inputs():
    tcfg_j = JTransformerConfig.tiny()
    vcfg_j = JVAEConfig.tiny(latent_channels=4, sample_height=64, sample_width=64)
    tp = perturb(init_transformer_params(jax.random.PRNGKey(0), tcfg_j), seed=1, scale=0.05)
    vp = perturb(init_vae_params(jax.random.PRNGKey(1), vcfg_j), seed=2, scale=0.05)
    common = dict(height=32, width=32, num_frames=9, num_inference_steps=2, guidance_scale=6.0, output_type="latent")
    inputs = (rand(1, 3, 4, 4, 4, seed=10), rand(1, 1, 4, 4, 4, seed=11), rand(2, 16, 32, seed=12), common)
    return tcfg_j, vcfg_j, tp, vp, inputs


@functools.lru_cache(maxsize=None)
def _jax_latents(name):
    spec, options = CASES[name]
    tcfg_j, vcfg_j, tp, vp, (latents, ref, embeds, common) = _pipeline_inputs()
    pipe = JS2VPipeline(transformer_params=jax.tree.map(jnp.asarray, tp), transformer_cfg=tcfg_j,
                        vae_params=jax.tree.map(jnp.asarray, vp), vae_cfg=vcfg_j, scheduler_cfg=JSchedulerConfig())
    pipe.set_mesh(spec)
    pipe.set_attention("xla")
    return np.asarray(pipe.generate(latents=jnp.asarray(latents), ref_latents=jnp.asarray(ref),
                                    prompt_embeds=jnp.asarray(embeds), **common, **options))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Each world size's ranks, spawned once: {world size: [rank results]}."""
    _, _, tp, vp, (latents, ref, embeds, common) = _pipeline_inputs()
    out = {}
    for world in (2, 4):
        cases = {name: ("generate", spec, dict(tp=tp, vp=vp, inputs=(latents, ref, embeds, {**common, **options}),
                                               grad_forward=1 if name == "dp4_cfg_skip" else None))
                 for name, (spec, options) in CASES.items() if _size(spec) == world}
        out[world] = run_mesh_ranks(world, cases, tmp_path_factory.mktemp(f"uneven{world}"), timeout_s=240)
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_generate_on_uneven_data_rows_matches_jax(ranks, name):
    """Every rank's latents equal JAX's under the same mesh, and rank 0's
    bit for bit; the cfg-skip cases skipped their uncond forward."""
    spec, options = CASES[name]
    want = _jax_latents(name)
    results = ranks[_size(spec)]
    for rank, res in enumerate(results):
        got = res[name]
        np.testing.assert_allclose(got["latents"], want, atol=ATOL, rtol=RTOL, err_msg=f"{name} rank {rank}")
        assert np.array_equal(got["latents"], results[0][name]["latents"]), (name, rank)
        if options is SKIP:
            assert got["stats"]["cfg_skipped_steps"] > 0, got["stats"]


def test_uneven_rows_under_autograd_still_raise(ranks):
    """A forward that records a gradient keeps the refusal: 1 row over 4
    data ranks raises with the sizes named."""
    for res in ranks[4]:
        assert "does not split over a data mesh dim of 4 ranks" in res["dp4_cfg_skip"]["grad_error"]
