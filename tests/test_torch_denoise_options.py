"""The rest of ``generate`` on the tiny pipelines, the port against the JAX
package on the same weights and injected inputs: DPM (JAX's ``fold_in``
draws injected into the port), cfg-skip in both CFG modes, adaptive step
skipping (the same decision at every step), segmented runs equal to the
whole loop, the segment callback's three outcomes, and the progress line."""

import importlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from _torch_parity import LATENT_ATOL, rand, t, tiny_pipelines
from s2v_torch.pipelines import denoise

# the module (the package re-exports a function of the same name)
j_denoise = importlib.import_module("s2v_tpu.pipelines.denoise")

COMMON = dict(height=32, width=32, num_frames=9, guidance_scale=6.0)


@pytest.fixture(scope="module")
def pipelines():
    return tiny_pipelines()


def _inputs(seed=10):
    return rand(1, 3, 4, 4, 4, seed=seed), rand(1, 1, 4, 4, 4, seed=seed + 1), rand(2, 16, 32, seed=seed + 2)


def _jax_dpm_noise(seed):
    """The JAX generate's DPM draws for ``seed`` (its third split key,
    ``fold_in(key, 2i)`` and ``fold_in(key, 2i + 1)``), as a port noise source."""
    k_dpm = jax.random.split(jax.random.PRNGKey(seed), 3)[2]

    def noise(i, shape, device):
        return tuple(t(jax.random.normal(jax.random.fold_in(k_dpm, 2 * i + j), tuple(shape), jnp.float32))
                     .to(device) for j in (0, 1))

    return noise


def _run_both(jax_pipe, port, steps, **kw):
    lat, ref, emb = _inputs()
    j = jax_pipe.generate(latents=jnp.asarray(lat), ref_latents=jnp.asarray(ref), prompt_embeds=jnp.asarray(emb),
                          num_inference_steps=steps, output_type="latent", **COMMON, **kw)
    p = port.generate(latents=t(lat), ref_latents=t(ref), prompt_embeds=t(emb), num_inference_steps=steps,
                      output_type="latent", **COMMON, **kw)
    return np.asarray(j), p


def test_dpm_generate_matches_jax_with_its_draws_injected(pipelines):
    jax_pipe, port = pipelines
    port.dpm_noise = _jax_dpm_noise(5)
    try:
        lat_j, lat_t = _run_both(jax_pipe, port, 3, use_dpm=True, seed=5)
    finally:
        port.dpm_noise = None
    np.testing.assert_allclose(lat_t.numpy(), lat_j, atol=LATENT_ATOL, rtol=1e-4)
    # the port's own draws: seeded, so the same seed gives the same latents, and they are DPM's
    _, again = _run_both(jax_pipe, port, 3, use_dpm=True, seed=5)
    _, own = _run_both(jax_pipe, port, 3, use_dpm=True, seed=5)
    assert torch.equal(again, own) and not torch.allclose(own, lat_t)


def test_dpm_noise_is_seeded_by_the_step_index():
    noise = denoise.DPMNoise(123)
    a1, a2 = noise(3, (2, 4), "cpu")
    b1, b2 = denoise.DPMNoise(123)(3, (2, 4), "cpu")
    assert torch.equal(a1, b1) and torch.equal(a2, b2) and not torch.equal(a1, a2)
    assert not torch.equal(noise(4, (2, 4), "cpu")[0], a1)


@pytest.mark.parametrize("cfg_mode", ["batched", "sequential"])
def test_cfg_skip_matches_jax(pipelines, cfg_mode):
    jax_pipe, port = pipelines
    lat_j, lat_t = _run_both(jax_pipe, port, 6, use_dynamic_cfg=True, cfg_skip_threshold=0.05, cfg_mode=cfg_mode)
    np.testing.assert_allclose(lat_t.numpy(), lat_j, atol=LATENT_ATOL, rtol=1e-4)
    sched = j_denoise.DenoiseSchedule.create(jax_pipe.scheduler_cfg, 6, 6.0, use_dynamic_cfg=True)
    n_skip = int(np.sum(sched.guidance - 1.0 < 0.05))
    assert 0 < n_skip < 6  # both branches run
    assert port.stats["cfg_skipped_steps"] == n_skip
    # the skipped steps differ from the exact loop's
    _, exact = _run_both(jax_pipe, port, 6, use_dynamic_cfg=True, cfg_mode=cfg_mode)
    assert not torch.allclose(exact, lat_t, atol=1e-5)


def _denoise_args(jax_pipe, port):
    lat, ref, emb = _inputs(seed=20)
    jcos, jsin = jax_pipe.prepare_rope(32, 32, 3)
    pcos, psin = port.prepare_rope(32, 32, 3)
    j = (jax_pipe.transformer_params, jax_pipe.transformer_cfg, jnp.asarray(ref), jnp.asarray(emb), jcos, jsin)
    p = (port.transformer_params, port.transformer_cfg, t(ref), t(emb), pcos, psin)
    return lat, j, p


@pytest.mark.parametrize("threshold", [0.0, 1e9, 0.02])
def test_adaptive_decisions_match_jax_at_every_step(pipelines, threshold):
    """The skip decision of each step and the final count, JAX's step
    function run eagerly beside the port's."""
    jax_pipe, port = pipelines
    steps = 8
    lat, (jp, jcfg, jref, jemb, jcos, jsin), (pp, pcfg, pref, pemb, pcos, psin) = _denoise_args(jax_pipe, port)
    jsched = j_denoise.DenoiseSchedule.create(jax_pipe.scheduler_cfg, steps, 6.0)
    psched = denoise.DenoiseSchedule.create(port.scheduler_cfg, steps, 6.0)
    jstep = j_denoise._build_adaptive_step_fn(jp, jcfg, jsched, jref, jemb, jcos, jsin, threshold, True, None,
                                              "xla", None, "batched", None)
    pstep = denoise._build_adaptive_step_fn(pp, pcfg, psched, pref, pemb, pcos, psin, threshold, True, None,
                                            "plain", "batched")
    jcarry = j_denoise.adaptive_init_carry(jnp.asarray(lat))
    pcarry = denoise.adaptive_init_carry(t(lat))
    jdecisions, pdecisions = [], []
    for i in range(steps):
        before_j, before_p = int(jcarry[5]), pcarry[5]
        jcarry, pcarry = jstep(i, jcarry), pstep(i, pcarry)
        jdecisions.append(int(jcarry[5]) - before_j)
        pdecisions.append(pcarry[5] - before_p)
    assert pdecisions == jdecisions
    assert pcarry[5] == int(jcarry[5])
    if threshold == 1e9:
        assert pdecisions == [0, 0] + [1] * (steps - 3) + [0]  # steps 0, 1 and the last always compute
    if threshold == 0.0:
        assert sum(pdecisions) == 0
    np.testing.assert_allclose(pcarry[0].numpy(), np.asarray(jcarry[0]), atol=LATENT_ATOL, rtol=1e-4)


def test_adaptive_generate_matches_jax(pipelines):
    jax_pipe, port = pipelines
    lat_j, lat_t = _run_both(jax_pipe, port, 6, adaptive_threshold=1e9)
    np.testing.assert_allclose(lat_t.numpy(), lat_j, atol=LATENT_ATOL, rtol=1e-4)
    assert port.stats["adaptive_skipped_steps"] == 3 and port.stats["steps_run"] == 6


@pytest.mark.parametrize("kw", [dict(), dict(adaptive_threshold=0.02), dict(adaptive_threshold=1e9),
                                dict(use_dpm=True), dict(use_dynamic_cfg=True, cfg_skip_threshold=0.05)],
                         ids=["plain", "adaptive_0.02", "adaptive_1e9", "dpm", "cfg_skip"])
def test_segmented_equals_the_whole_loop(pipelines, kw):
    """Segments of 2, 3 and 4 steps give the whole loop's latents bit for
    bit (the adaptive state and the DPM draws cross segment boundaries),
    and the segmented run matches JAX's whole loop."""
    jax_pipe, port = pipelines
    lat, ref, emb = _inputs()
    args = dict(latents=t(lat), ref_latents=t(ref), prompt_embeds=t(emb), num_inference_steps=6,
                output_type="latent", seed=3, **COMMON, **kw)
    whole = port.generate(**args)
    for seg in (2, 3, 4):
        assert torch.equal(port.generate(segment_steps=seg, **args), whole), seg
    if not kw.get("use_dpm"):
        lat_j, _ = _run_both(jax_pipe, port, 6, **kw)
        np.testing.assert_allclose(whole.numpy(), lat_j, atol=LATENT_ATOL, rtol=1e-4)


def test_segmented_denoise_runner_matches_jax(pipelines):
    jax_pipe, port = pipelines
    lat, (jp, jcfg, jref, jemb, jcos, jsin), (pp, pcfg, pref, pemb, pcos, psin) = _denoise_args(jax_pipe, port)
    jsched = j_denoise.DenoiseSchedule.create(jax_pipe.scheduler_cfg, 4, 6.0)
    psched = denoise.DenoiseSchedule.create(port.scheduler_cfg, 4, 6.0)
    full = j_denoise.denoise(jp, jcfg, jsched, jnp.asarray(lat), jref, jemb, jcos, jsin)
    run = denoise.make_segmented_denoise(pp, pcfg, psched, pcos, psin)
    carry = (t(lat), torch.zeros(lat.shape))
    carry = run(None, carry, pref, pemb, None, 0, 1)
    carry = run(None, carry, pref, pemb, None, 1, 4)
    np.testing.assert_allclose(carry[0].numpy(), np.asarray(full), atol=LATENT_ATOL, rtol=1e-4)


def _callback_run(pipe, callback, to):
    lat, ref, emb = _inputs()
    return pipe.generate(latents=to(lat), ref_latents=to(ref), prompt_embeds=to(emb), num_inference_steps=4,
                         output_type="latent", segment_steps=2, callback_on_segment_end=callback, **COMMON)


@pytest.mark.parametrize("outcome", ["false", "false_tensor", "replace", "ignored"])
def test_callback_outcomes_match_jax(pipelines, outcome):
    jax_pipe, port = pipelines
    seen = []

    def make(zero_d_false, like):
        def callback(i, latents):
            seen.append(i)
            if outcome == "false":
                return False
            if outcome == "false_tensor":
                return zero_d_false
            if outcome == "replace":
                return latents * 0.5 if i == 2 else None
            return like  # neither a flag nor a tensor of the latents' shape

        return callback

    lat_j = np.asarray(_callback_run(jax_pipe, make(jnp.all(jnp.zeros(2, bool)), jnp.zeros(3)), jnp.asarray))
    jax_seen, seen[:] = list(seen), []
    lat_t = _callback_run(port, make(torch.all(torch.zeros(2, dtype=torch.bool)), torch.zeros(3)), t)
    assert seen == jax_seen == ([2] if outcome.startswith("false") else [2, 4])
    assert port.stats["steps_run"] == (2 if outcome.startswith("false") else 4)
    np.testing.assert_allclose(lat_t.numpy(), lat_j, atol=LATENT_ATOL, rtol=1e-4)
    if outcome == "ignored":
        lat, ref, emb = _inputs()
        whole = port.generate(latents=t(lat), ref_latents=t(ref), prompt_embeds=t(emb), num_inference_steps=4,
                              output_type="latent", **COMMON)
        assert torch.equal(lat_t, whole)


def test_callback_needs_segments(pipelines):
    _, port = pipelines
    lat, ref, emb = _inputs()
    with pytest.raises(ValueError, match="segment_steps"):
        port.generate(latents=t(lat), ref_latents=t(ref), prompt_embeds=t(emb), num_inference_steps=2,
                      callback_on_segment_end=lambda i, x: None, **COMMON)


def test_progress_line_and_logs_on_stderr(pipelines, capsys):
    _, port = pipelines
    lat, ref, emb = _inputs()
    port.generate(latents=t(lat), ref_latents=t(ref), prompt_embeds=t(emb), num_inference_steps=3,
                  output_type="latent", progress=True, use_dynamic_cfg=True, cfg_skip_threshold=0.05, **COMMON)
    err = capsys.readouterr().err
    assert "\r[s2v_torch] denoise step 1/3" in err and "\r[s2v_torch] denoise step 3/3\n" in err
    assert "s2v_torch.pipeline: cfg-skip: uncond forward skipped on 1/3 steps" in err
    assert "[INFO] s2v_torch: denoise:" in err


def test_generate_takes_jax_arguments_in_jax_order():
    import inspect

    from s2v_tpu.pipelines.s2v import S2VPipeline as JS2VPipeline
    from s2v_torch.pipelines.s2v import S2VPipeline

    assert list(inspect.signature(S2VPipeline.generate).parameters) == list(
        inspect.signature(JS2VPipeline.generate).parameters)
