"""The tiny DiT with its video stream sharded by latent frames over 2 gloo
ranks (``s2v_torch/models/transformer.py`` under a ``seq`` mesh), against the
JAX package under ``mesh="sp2"`` with ``sp_allgather``: the forward (RoPE
with the ``sp_allgather``, ``sp_ulysses`` and ``ring`` backends; a sincos
config), ``generate`` (the exact backend routed to ``sp_allgather``; with
the context-parallel VAE decode of 4 latent frames in 2 chunks, and a sincos
config to latents), and the LoRA loss and its gradients (``sp_allgather``,
``ring``, and ``plain`` on the gathered rows) against ``jax.grad``; also
``plain`` and ``chunked`` on the gathered rows against JAX's ``xla`` and
``chunked``.  5 latent frames on 2 ranks leave one dummy frame.  The ranks
run in spawned processes (``tests/_torch_sp_worker.py``); the spawn runs
every case at once and has its own time limit."""

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
from s2v_tpu.models.transformer import transformer_forward as j_forward
from s2v_tpu.models.vae import init_vae_params
from s2v_tpu.ops import sincos as j_sincos
from s2v_tpu.ops.rope import build_segmented_rope, get_3d_rotary_pos_embed
from s2v_tpu.parallel import default_logical_map as j_logical_map
from s2v_tpu.parallel import mesh_context as j_mesh_context
from s2v_tpu.parallel.sharding import make_mesh
from s2v_tpu.pipelines.s2v import S2VPipeline as JS2VPipeline
from s2v_tpu.training import lora as j_lora
from test_torch_windowed import ALPHAS, _close_to_max, _jax_draws, _lora_case

# the tiny DiT and generate in fp32, as tests/test_torch_sp_attention.py
ATOL, RTOL = 1e-4, 1e-4
GEN_ATOL = 2e-4
FRAMES = 5
EXACT = ("sp_allgather", "sp_ulysses", "ring")
# the single-card backends that run on the ring's gathered rows, and their JAX names
GATHERED = {"plain": "xla", "chunked": "chunked"}
LORA_BACKENDS = ("sp_allgather", "ring", "plain")


def _jax_mesh():
    mesh = make_mesh({"seq": 2}, jax.devices()[:2])
    return mesh, j_mesh_context(mesh, j_logical_map(mesh))


@functools.lru_cache(maxsize=None)
def _forward_case(sincos, jax_backend="sp_allgather"):
    """Params, inputs and JAX's sp2 forward of a 3-stream tiny DiT."""
    over = dict(use_rotary_positional_embeddings=False) if sincos else {}
    cfg_j = JTransformerConfig.tiny(**over)
    params = perturb(init_transformer_params(jax.random.PRNGKey(0), cfg_j), seed=1)
    b, f, h, w = 2, FRAMES, 8, 8
    c = cfg_j.in_channels
    video, ref = rand(b, f, h, w, c, seed=2), rand(b, 1, h, w, c, seed=3)
    text = rand(b, cfg_j.max_text_seq_length, cfg_j.text_embed_dim, seed=4)
    ts = np.array([999, 500], np.int32)
    if sincos:
        table = np.asarray(j_sincos.joint_text_video_pos_embedding(cfg_j.inner_dim, h, w, 4 * (f - 1) + 1, 2, 4,
                                                                   cfg_j.max_text_seq_length))
        cs = sn = None
        kw = dict(pos_embedding=jnp.asarray(table))
    else:
        gh, gw = h // 2, w // 2
        cos, sin = get_3d_rotary_pos_embed(cfg_j.attention_head_dim, ((0, 0), (gh, gw)), (gh, gw), f + 1)
        tok = gh * gw
        cs, sn = (np.asarray(x) for x in build_segmented_rope(cfg_j.max_text_seq_length, cos[:tok], sin[:tok],
                                                              cos[tok:], sin[tok:]))
        table = None
        kw = dict(rope_cos=jnp.asarray(cs), rope_sin=jnp.asarray(sn))
    _, ctx = _jax_mesh()
    with ctx:
        want = j_forward(params, cfg_j, jnp.asarray(video), jnp.asarray(ref), jnp.asarray(text), jnp.asarray(ts),
                         attention_backend=jax_backend, **kw)
    inputs = (video, ref, text, ts, cs, sn) + ((table,) if sincos else ())
    return params, inputs, np.asarray(want), over


@functools.lru_cache(maxsize=None)
def _generate_case(sincos):
    over = dict(use_rotary_positional_embeddings=False) if sincos else {}
    tcfg_j = JTransformerConfig.tiny(**over)
    vcfg_j = JVAEConfig.tiny(latent_channels=4, sample_height=64, sample_width=64)
    tp = perturb(init_transformer_params(jax.random.PRNGKey(0), tcfg_j), seed=1, scale=0.05)
    vp = perturb(init_vae_params(jax.random.PRNGKey(1), vcfg_j), seed=2, scale=0.05)
    # 13 frames: 4 latent frames, which 2 ranks decode as 2 chunks of the VAE's 2-frame batch
    common = dict(height=32, width=32, num_frames=13 if not sincos else 9, num_inference_steps=2,
                  guidance_scale=6.0, output_type="latent" if sincos else "np")
    f_lat = (common["num_frames"] - 1) // 4 + 1
    inputs = (rand(1, f_lat, 4, 4, 4, seed=10), rand(1, 1, 4, 4, 4, seed=11), rand(2, 16, 32, seed=12), common)
    jax_pipe = JS2VPipeline(transformer_params=jax.tree.map(jnp.asarray, tp), transformer_cfg=tcfg_j,
                            vae_params=jax.tree.map(jnp.asarray, vp), vae_cfg=vcfg_j, scheduler_cfg=JSchedulerConfig())
    jax_pipe.set_mesh("sp2")
    jax_pipe.set_attention("sp_allgather")
    latents, ref, embeds, _ = inputs
    want = np.asarray(jax_pipe.generate(latents=jnp.asarray(latents), ref_latents=jnp.asarray(ref),
                                        prompt_embeds=jnp.asarray(embeds), **common))
    return tp, vp, inputs, want, over


@functools.lru_cache(maxsize=None)
def _lora_kwargs():
    cfg_j, base, batch, spec, tree = _lora_case()
    # 5 latent frames: one dummy frame on 2 ranks
    b, _, h, w, c = batch["video_latents"].shape
    batch = dict(batch, video_latents=rand(b, FRAMES, h, w, c, seed=2))
    gh, gw = h // 2, w // 2
    cos, sin = get_3d_rotary_pos_embed(cfg_j.attention_head_dim, ((0, 0), (gh, gw)), (gh, gw), FRAMES + 1)
    tok = gh * gw
    cs, sn = build_segmented_rope(cfg_j.max_text_seq_length, cos[:tok], sin[:tok], cos[tok:], sin[tok:])
    batch["rope_cos"], batch["rope_sin"] = np.asarray(cs), np.asarray(sn)
    rng = jax.random.PRNGKey(11)
    _, ctx = _jax_mesh()
    with ctx:
        loss_j, grads_j = jax.value_and_grad(j_lora.lora_loss_fn)(
            jax.tree.map(jnp.asarray, tree), base, cfg_j, spec, {k: jnp.asarray(v) for k, v in batch.items()},
            jnp.asarray(ALPHAS), rng, "sp_allgather", True)
    ts, noise = _jax_draws(rng, batch["video_latents"].shape)
    kwargs = dict(base=base, batch={**batch, "alphas_cumprod": ALPHAS}, tree=tree, rank=spec.rank, alpha=spec.alpha,
                  timesteps=ts.numpy(), noise=noise.numpy(), window=1)
    return (float(loss_j), jax.tree.map(np.asarray, grads_j)), kwargs


def _cases():
    cases = {}
    params, inputs, _, _ = _forward_case(False)
    for backend in EXACT:
        cases[f"forward_{backend}"] = ("forward", dict(params=params, inputs=inputs, window=1, backend=backend))
    for backend in GATHERED:
        cases[f"forward_{backend}"] = ("forward", dict(params=params, inputs=inputs, window=1, backend=backend))
    cases["flash_on_ring"] = ("forward_error", dict(params=params, inputs=inputs, backend="flash"))
    params, inputs, _, over = _forward_case(True)
    cases["forward_sincos"] = ("forward", dict(params=params, inputs=inputs, window=1, backend="sp_allgather",
                                               cfg_kw=over))
    for sincos in (False, True):
        tp, vp, inputs, _, over = _generate_case(sincos)
        cases[f"generate_{'sincos' if sincos else 'rope'}"] = ("generate", dict(tp=tp, vp=vp, inputs=inputs, window=1,
                                                                               backend="flash", cfg_kw=over))
    for backend in LORA_BACKENDS:
        cases[f"lora_{backend}"] = ("lora", dict(_lora_kwargs()[1], backend=backend))
    kw = _lora_kwargs()[1]
    cases["full_grads"] = ("full_grads", {k: kw[k] for k in ("base", "batch", "timesteps", "noise")})
    return cases


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks(2, _cases(), tmp_path_factory.mktemp("sp_dit"), timeout_s=240)


@pytest.mark.parametrize("backend", EXACT + ("sincos",))
def test_forward_matches_jax_sp2(ranks, backend):
    _, _, want, _ = _forward_case(backend == "sincos")
    for rank, res in enumerate(ranks):
        np.testing.assert_allclose(res[f"forward_{backend}"]["out"], want, atol=ATOL, rtol=RTOL, err_msg=f"rank {rank}")


@pytest.mark.parametrize("positions", ["rope", "sincos"])
def test_generate_matches_jax_sp2(ranks, positions):
    """The exact backend routed to sp_allgather on the ring; every rank ends
    with the same clip (the rope case decoded context-parallel)."""
    *_, want, _ = _generate_case(positions == "sincos")
    for rank, res in enumerate(ranks):
        got = res[f"generate_{positions}"]
        assert got["backend"] == "flash"  # the pipeline routes it per call
        np.testing.assert_allclose(got["latents"], want, atol=GEN_ATOL, rtol=RTOL, err_msg=f"rank {rank}")
        assert np.array_equal(got["latents"], ranks[0][f"generate_{positions}"]["latents"])


@pytest.mark.parametrize("backend", LORA_BACKENDS)
def test_lora_loss_and_grads_match_jax_sp2(ranks, backend):
    """The loss over the gathered prediction and the adapters' gradients,
    each rank's share summed over the ring, against ``jax.grad`` under
    JAX's sp2 mesh; every rank's equal to rank 0's."""
    (loss_j, grads_j), _ = _lora_kwargs()
    for rank, res in enumerate(ranks):
        got = res[f"lora_{backend}"]
        _close_to_max(got["loss"], loss_j)
        for name, g in got["grads"].items():
            target, k = name.rsplit(".", 1)
            _close_to_max(g, grads_j[target][k])
        assert got["loss"] == ranks[0][f"lora_{backend}"]["loss"]
        for name, g in got["grads"].items():
            assert np.array_equal(g, ranks[0][f"lora_{backend}"]["grads"][name]), (rank, name)


def test_full_loss_grads_are_summed_over_the_ring(ranks):
    """Full fine-tuning's loss on the ring: every parameter's gradient,
    each rank's share summed, against one process's with the plain
    attention; every rank's equal to rank 0's."""
    import torch

    from s2v_torch.config import TransformerConfig
    from s2v_torch.loaders.jax_params import transformer_from_jax
    from s2v_torch.training.full import floating_leaves, vpred_loss

    kw = _lora_kwargs()[1]
    cfg = TransformerConfig.tiny()
    params = transformer_from_jax(kw["base"], cfg, device="cpu")
    leaves = floating_leaves(params)
    for x in leaves:
        x.requires_grad_(True)
    batch = {k: torch.from_numpy(np.array(v, np.float32)) for k, v in kw["batch"].items() if k != "alphas_cumprod"}
    loss = vpred_loss(params, cfg, batch, torch.from_numpy(ALPHAS), None, "plain", True,
                      timesteps=torch.from_numpy(kw["timesteps"]), noise=torch.from_numpy(kw["noise"]))
    want = torch.autograd.grad(loss, leaves)
    for rank, res in enumerate(ranks):
        got = res["full_grads"]
        _close_to_max(got["loss"], loss.item())
        assert len(got["grads"]) == len(want)
        for g, w in zip(got["grads"], want):
            _close_to_max(g, w.numpy())
        for g, g0 in zip(got["grads"], ranks[0]["full_grads"]["grads"]):
            assert np.array_equal(g, g0), rank


@pytest.mark.parametrize("backend", GATHERED)
def test_single_card_backend_on_a_ring_matches_jax_sp2(ranks, backend):
    """``plain`` and ``chunked`` on the ring's gathered rows against JAX's
    ``xla`` and ``chunked`` under sp2, which GSPMD partitions."""
    _, _, want, _ = _forward_case(False, GATHERED[backend])
    for rank, res in enumerate(ranks):
        np.testing.assert_allclose(res[f"forward_{backend}"]["out"], want, atol=ATOL, rtol=RTOL, err_msg=f"rank {rank}")


def test_a_single_card_backend_on_a_ring_raises(ranks):
    """On a ring of 2 the DiT refuses a single-card kernel backend (the
    pipeline routes ``flash`` to ``sp_allgather``)."""
    for res in ranks:
        assert "has no form on a seq ring of 2" in res["flash_on_ring"]["error"]
