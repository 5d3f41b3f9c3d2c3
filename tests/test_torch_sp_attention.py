"""The port's ``sp_windowed`` path (``s2v_torch/parallel/sp_attention.py``,
kernels B6/B7 through their plain versions) on the frame shards of real gloo
process groups of 1, 2 and 4 ranks, against the JAX package on 4 virtual CPU devices: the wrapper
against ``banded_allgather_attention(..., interpret=True)`` and the
``jax.grad`` of ``banded_allgather_attention_trainable``; the tiny DiT
forward, ``generate`` and the LoRA loss and grads against JAX's kernel-free
``windowed_xla``.  The ranks run in spawned processes that import torch and
s2v_torch only (``tests/_torch_sp_worker.py``); each spawn runs all its cases
at once and has its own time limit.  Also here: routing and the mesh
checks.  ``tests/test_torch_sp_backends.py`` holds the exact backends."""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from _torch_parity import band_inputs, perturb, rand
from _torch_sp_worker import assert_grads_match, assert_rows_match, global_rows_spread, run_ranks
from s2v_tpu.config import SchedulerConfig as JSchedulerConfig
from s2v_tpu.config import TransformerConfig as JTransformerConfig
from s2v_tpu.config import VAEConfig as JVAEConfig
from s2v_tpu.models.transformer import init_transformer_params
from s2v_tpu.models.vae import init_vae_params
from s2v_tpu.ops.attention import route_seq_backend as j_route_seq_backend
from s2v_tpu.parallel.sharding import make_mesh
from s2v_tpu.parallel.sp_attention import banded_allgather_attention as j_sp_attention
from s2v_tpu.parallel.sp_attention import banded_allgather_attention_trainable as j_sp_trainable
from s2v_tpu.pipelines.s2v import S2VPipeline as JS2VPipeline
from s2v_tpu.training import lora as j_lora
from s2v_torch.config import TransformerConfig
from s2v_torch.ops.attention import joint_attention, resolve_attention_backend, route_seq_backend
from s2v_torch.pipelines.s2v import S2VPipeline
from test_torch_windowed import ALPHAS, WINDOW, _close_to_max, _forward_case, _jax_draws, _lora_case

# the JAX package's own tolerances for this wrapper (tests/test_parallel.py:540-690)
FWD_ATOL, FWD_RTOL = 2e-5, 1e-4
GRAD_ATOL, GRAD_RTOL = 2e-4, 1e-3
# the tiny DiT and generate in fp32, as tests/test_torch_windowed.py:39-43 and :151
ATOL, RTOL = 1e-4, 1e-4
GEN_ATOL = 2e-4
BAND = (5, 4, 1)  # global_len, tokens_per_frame, w
FRAMES = (8, 6)  # 6 frames on 4 ranks: two dummy frames, one rank all dummy
FORWARD_FRAMES = {1: 4, 2: 5}  # 5 frames on 2 ranks: one dummy frame


def _attention_inputs(n_frames):
    g, tpf, _ = BAND
    return band_inputs(1, 2, g, tpf, n_frames, seed=100 + n_frames, d=8)


@functools.lru_cache(maxsize=None)
def _jax_attention(n_frames):
    """JAX's forward and grads of sum(o * ct) on a 4-device seq mesh, interpret mode."""
    mesh = make_mesh({"seq": 4}, jax.devices()[:4])
    q, k, v, ct = (jnp.asarray(x) for x in _attention_inputs(n_frames))
    o = j_sp_attention(q, k, v, mesh, "seq", *BAND, interpret=True)

    def loss(q_, k_, v_):
        return jnp.sum(j_sp_trainable(q_, k_, v_, mesh, "seq", *BAND, True) * ct)

    return np.asarray(o), [np.asarray(x) for x in jax.grad(loss, argnums=(0, 1, 2))(q, k, v)]


@functools.lru_cache(maxsize=None)
def _forward(n_frames):
    """The 3-stream DiT case of test_torch_windowed.py and JAX's windowed_xla output."""
    return _forward_case(True, f=n_frames)


@functools.lru_cache(maxsize=None)
def _generate_case():
    tcfg_j = JTransformerConfig.tiny()
    vcfg_j = JVAEConfig.tiny(latent_channels=4, sample_height=64, sample_width=64)
    tp = perturb(init_transformer_params(jax.random.PRNGKey(0), tcfg_j), seed=1, scale=0.05)
    vp = perturb(init_vae_params(jax.random.PRNGKey(1), vcfg_j), seed=2, scale=0.05)
    inputs = (rand(1, 4, 4, 4, 4, seed=10), rand(1, 1, 4, 4, 4, seed=11), rand(2, 16, 32, seed=12),
              dict(height=32, width=32, num_frames=13, num_inference_steps=2, guidance_scale=6.0,
                   output_type="latent"))
    return tcfg_j, vcfg_j, tp, vp, inputs


@functools.lru_cache(maxsize=None)
def _lora_kwargs():
    cfg_j, base, batch, spec, tree = _lora_case()
    rng = jax.random.PRNGKey(11)
    ts, noise = _jax_draws(rng, batch["video_latents"].shape)
    kwargs = dict(base=base, batch={**batch, "alphas_cumprod": ALPHAS}, tree=tree, rank=spec.rank, alpha=spec.alpha,
                  timesteps=ts.numpy(), noise=noise.numpy(), window=WINDOW)
    return (cfg_j, base, batch, spec, tree, rng), kwargs


def _cases(world_size):
    cases = {}
    for f in FRAMES:
        q, k, v, ct = _attention_inputs(f)
        cases[f"attention_F{f}"] = ("attention", dict(q=q, k=k, v=v, ct=ct, band=BAND))
    if world_size in FORWARD_FRAMES:
        params, inputs, _ = _forward(FORWARD_FRAMES[world_size])
        cases["forward"] = ("forward", dict(params=params, inputs=inputs, window=WINDOW))
        if world_size > 1:
            cases["forward_windowed_plain"] = ("forward", dict(params=params, inputs=inputs, window=WINDOW,
                                                               backend="windowed_plain"))
    if world_size == 1:
        _, _, tp, vp, inputs = _generate_case()
        cases["generate"] = ("generate", dict(tp=tp, vp=vp, inputs=inputs, window=WINDOW))
    if world_size == 2:
        cases["lora"] = ("lora", _lora_kwargs()[1])
    return cases


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Each world size's spawn, run once on first use: a list of the ranks' results."""
    runs = {}

    def get(world_size):
        if world_size not in runs:
            runs[world_size] = run_ranks(world_size, _cases(world_size),
                                         tmp_path_factory.mktemp(f"sp_ws{world_size}"))
        return runs[world_size]

    return get


@pytest.mark.parametrize("world_size", [1, 2, 4])
@pytest.mark.parametrize("n_frames", FRAMES)
def test_wrapper_forward_matches_jax(ranks, world_size, n_frames):
    """Each rank's own rows (text, ref and its real frames) against the same rows of JAX's output."""
    want, _ = _jax_attention(n_frames)
    assert_rows_match(ranks(world_size), f"attention_F{n_frames}", want, ("o_inference", "o"), FWD_ATOL, FWD_RTOL)


@pytest.mark.parametrize("world_size", [1, 2, 4])
@pytest.mark.parametrize("n_frames", FRAMES)
def test_wrapper_grads_match_jax(ranks, world_size, n_frames):
    _, want = _jax_attention(n_frames)
    assert_grads_match(ranks(world_size), f"attention_F{n_frames}", want, GRAD_ATOL, GRAD_RTOL)


@pytest.mark.parametrize("world_size", [2, 4])
def test_ranks_hold_the_same_result(ranks, world_size):
    """Every rank computes the replicated text and ref rows of the output
    and lse itself, from the same gathered keys in the same order: bit for
    bit rank 0's."""
    results = ranks(world_size)
    for case in results[0]:
        if case.startswith("attention"):
            assert global_rows_spread(results, case) == 0.0, case


@pytest.mark.parametrize("world_size", [1, 2])
def test_transformer_forward_matches_jax_windowed(ranks, world_size):
    _, _, want = _forward(FORWARD_FRAMES[world_size])
    for rank, res in enumerate(ranks(world_size)):
        np.testing.assert_allclose(res["forward"]["out"], want, atol=ATOL, rtol=RTOL, err_msg=f"rank {rank}")


def test_windowed_plain_on_a_ring_matches_jax(ranks):
    """``windowed_plain`` (JAX ``windowed_xla``, which GSPMD partitions) on
    a ring of 2: the DiT's frame shards, the attention on the gathered rows."""
    _, _, want = _forward(FORWARD_FRAMES[2])
    for rank, res in enumerate(ranks(2)):
        np.testing.assert_allclose(res["forward_windowed_plain"]["out"], want, atol=ATOL, rtol=RTOL,
                                   err_msg=f"rank {rank}")


def test_generate_matches_jax_windowed(ranks):
    """``set_mesh`` (a seq ring of 1) and ``set_attention("sp_windowed", 1)``:
    2 DDIM steps with batched CFG over 4 latent frames against JAX
    ``generate`` with ``windowed_xla``."""
    tcfg_j, vcfg_j, tp, vp, (latents, ref, embeds, common) = _generate_case()
    jax_pipe = JS2VPipeline(transformer_params=jax.tree.map(jnp.asarray, tp), transformer_cfg=tcfg_j,
                            vae_params=jax.tree.map(jnp.asarray, vp), vae_cfg=vcfg_j, scheduler_cfg=JSchedulerConfig())
    jax_pipe.set_attention("windowed_xla", WINDOW)
    want = np.asarray(jax_pipe.generate(latents=jnp.asarray(latents), ref_latents=jnp.asarray(ref),
                                        prompt_embeds=jnp.asarray(embeds), **common))
    (res,) = ranks(1)
    assert res["generate"]["backend"] == "sp_windowed"
    np.testing.assert_allclose(res["generate"]["latents"], want, atol=GEN_ATOL, rtol=RTOL)


def test_lora_loss_and_grads_match_jax_windowed(ranks):
    """World size 2: the LoRA loss and grads against JAX ``windowed_xla``,
    and every rank's equal to rank 0's."""
    (cfg_j, base, batch, spec, tree, rng), _ = _lora_kwargs()
    loss_j, grads_j = jax.value_and_grad(j_lora.lora_loss_fn)(
        jax.tree.map(jnp.asarray, tree), base, cfg_j, spec, {k: jnp.asarray(v) for k, v in batch.items()},
        jnp.asarray(ALPHAS), rng, "windowed_xla", True)
    results = ranks(2)
    for rank, res in enumerate(results):
        got = res["lora"]
        _close_to_max(got["loss"], float(loss_j))
        for name, g in got["grads"].items():
            target, k = name.rsplit(".", 1)
            _close_to_max(g, np.asarray(grads_j[target][k]))
        assert got["loss"] == results[0]["lora"]["loss"]
        for name, g in got["grads"].items():
            assert np.array_equal(g, results[0]["lora"]["grads"][name]), (rank, name)


# ---------------------------------------------------------------------------
# routing and raises (in process, no process group)
# ---------------------------------------------------------------------------

# the port's names for the JAX package's single-card backends
_PORT_NAME = {"pallas": "flash", "pallas_int8": "flash_int8", "xla": "plain", "windowed_xla": "windowed_plain"}


@pytest.mark.parametrize("backend,heads,ring,tp", [
    ("pallas", 48, 1, 1), ("pallas", 48, 2, 1), ("pallas_int8", 48, 4, 1), ("windowed", 48, 2, 1),
    ("windowed", 48, 1, 1), ("windowed", 48, 4, 1), ("windowed_gather", 48, 2, 1), ("windowed_gather", 48, 1, 1),
    ("sp_ulysses", 48, 4, 1), ("sp_ulysses", 48, 16, 2), ("xla", 48, 2, 1), ("windowed_xla", 48, 4, 1),
    ("sp_windowed", 48, 2, 1),
])
def test_route_seq_backend_matches_jax(backend, heads, ring, tp):
    """The JAX routing (``s2v_tpu/ops/attention.py:78-101``) in the port's
    names, reason included; every sequence-parallel route is ported."""
    port_backend = _PORT_NAME.get(backend, backend)
    try:
        want = j_route_seq_backend(backend, heads, ring, tp)
    except ValueError:
        with pytest.raises(ValueError):
            route_seq_backend(port_backend, heads, ring, tp)
        return
    got = route_seq_backend(port_backend, heads, ring, tp)
    assert got == (_PORT_NAME.get(want[0], want[0]), want[1])


@pytest.mark.parametrize("backend", ["ring", "sp_allgather", "sp_int8", "sp_ulysses"])
def test_unported_seq_backends_raise(backend):
    """JAX's sequence-parallel backends, once unported, now resolve to themselves."""
    assert resolve_attention_backend(backend, torch.device("cpu")) == backend


def _attn_params(d):
    return {"qkv": {"weight": torch.randn(3 * d, d), "bias": torch.zeros(3 * d)},
            "norm_q": {"weight": torch.ones(16), "bias": torch.zeros(16)},
            "norm_k": {"weight": torch.ones(16), "bias": torch.zeros(16)},
            "to_out": {"weight": torch.randn(d, d), "bias": torch.zeros(d)}}


def test_sp_windowed_without_a_mesh_raises():
    """No single-card backend stands in: without a mesh context (or with a
    mapping that has no sp axis) sp_windowed raises."""
    from s2v_torch.parallel import mesh_context

    cfg = TransformerConfig.tiny()
    d = cfg.inner_dim
    x = torch.randn(1, 12, d)
    with pytest.raises(ValueError, match="sp_windowed needs an active mesh"):
        joint_attention(_attn_params(d), x, cfg.num_attention_heads, backend="sp_windowed", window=(4, 4, 0))
    with mesh_context(object(), {"dp": None, "tp": None, "sp": None}):
        with pytest.raises(ValueError, match="sp_windowed needs an active mesh"):
            joint_attention(_attn_params(d), x, cfg.num_attention_heads, backend="sp_windowed", window=(4, 4, 0))
    with mesh_context(object(), {"dp": "data", "tp": "model", "sp": None}):
        with pytest.raises(ValueError, match="sp_windowed needs an active mesh"):
            joint_attention(_attn_params(d), x, cfg.num_attention_heads, backend="sp_windowed", window=(4, 4, 0))


class _FakeMesh:
    """What ``set_mesh`` reads of a ``DeviceMesh``: its dim names, device
    type and sizes."""

    def __init__(self, names, sizes, device_type="cpu"):
        self.mesh_dim_names, self._sizes, self.device_type = names, sizes, device_type

    def size(self, dim):
        return self._sizes[dim]


def _tiny_pipe():
    from s2v_torch.config import VAEConfig
    from s2v_torch.models.transformer import init_transformer_params_random
    from s2v_torch.models.vae import init_vae_params_random

    tcfg, vcfg = TransformerConfig.tiny(), VAEConfig.tiny(latent_channels=4, sample_height=64, sample_width=64)
    return S2VPipeline(init_transformer_params_random(tcfg, device="cpu"), tcfg,
                       init_vae_params_random(vcfg, device="cpu"), vcfg, device="cpu")


def test_set_mesh_takes_a_seq_dim_only():
    """``set_mesh`` takes every dim: without a model dim the params stay as
    they are; a model dim (a one-rank ``tp1,sp1`` mesh here) slices them in
    place, and ``set_mesh(None)`` gathers them back whole, bit for bit."""
    import torch.distributed as dist

    pipe = _tiny_pipe()
    whole = pipe.transformer_params
    assert pipe._seq_ring() == 1
    pipe.set_mesh(_FakeMesh(("seq",), (4,)))
    assert pipe._seq_ring() == 4
    for names in (("data",), ("data", "seq")):
        pipe.set_mesh(_FakeMesh(names, (2, 2)))
        assert pipe._seq_ring() == (2 if "seq" in names else 1) and pipe.transformer_params is whole
    with pytest.raises(ValueError):
        pipe.set_mesh(_FakeMesh(("seq",), (1,), device_type="cuda"))
    pipe.set_mesh(None)
    assert pipe.mesh is None and pipe._seq_ring() == 1
    try:
        pipe.set_mesh("tp1,sp1")  # a one-rank group over a HashStore
        assert pipe._tp_specs is not None and pipe.transformer_params is not whole
        pipe.set_mesh(None)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    qkv = lambda p: p["blocks"][0]["attn"]["qkv"]["weight"]  # noqa: E731
    assert pipe._tp_specs is None and torch.equal(qkv(pipe.transformer_params), qkv(whole))


def test_generate_on_a_ring_routes_and_raises_for_unported():
    """On a ring of 2 (a stand-in mesh: the raises come before any
    collective) the exact backend routes to sp_allgather and
    windowed_gather raises; and sp_windowed without set_mesh raises."""
    pipe = _tiny_pipe()
    kw = dict(latents=torch.randn(1, 2, 4, 4, 4), ref_latents=torch.randn(1, 1, 4, 4, 4),
              prompt_embeds=torch.randn(2, 16, 32), height=32, width=32, num_frames=5, num_inference_steps=1,
              output_type="latent")
    pipe.set_attention("sp_windowed", 1)
    with pytest.raises(ValueError, match="sp_windowed needs an active mesh"):
        pipe.generate(**kw)
    pipe.set_mesh(_FakeMesh(("seq",), (2,)))
    pipe.set_attention("flash")
    cfg = pipe.transformer_cfg
    assert route_seq_backend(pipe.attention_backend, cfg.num_attention_heads, pipe._seq_ring()) == ("sp_allgather",
                                                                                                    None)
    pipe.set_attention("windowed_gather", 1)
    with pytest.raises(ValueError, match="no sequence-parallel"):
        pipe.generate(**kw)
