"""The port's LoRA training path against the JAX package's, on the tiny DiT
in fp32: runtime LoRA in ``dense`` and in the forward, remat, the
v-prediction loss, ``lora_loss_fn`` grads, train steps per optimizer spec,
the LR schedules, the exports, ``latent_batches`` and device timesteps.

Inputs are made with numpy from seeds and handed to both packages; the
JAX package's random draws (timesteps, noise) are reproduced here and passed
to the port through its ``timesteps=``/``noise=`` hooks."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from _torch_parity import np_tree, perturb, rand, t
from s2v_tpu.config import SchedulerConfig as JSchedulerConfig
from s2v_tpu.config import TransformerConfig as JTransformerConfig
from s2v_tpu.models.transformer import RUNTIME_LORA_KEY as J_RUNTIME_LORA_KEY
from s2v_tpu.models.transformer import init_transformer_params, transformer_forward as j_forward
from s2v_tpu.ops.quant import dense as j_dense
from s2v_tpu.ops.rope import build_segmented_rope, get_3d_rotary_pos_embed
from s2v_tpu.schedulers import ddim as j_ddim
from s2v_tpu.training import lora as j_lora
from s2v_tpu.training import optim as j_optim
from s2v_tpu.training.full import vpred_loss as j_vpred_loss
from s2v_torch.config import TransformerConfig
from s2v_torch.loaders.jax_params import lora_from_jax, transformer_from_jax
from s2v_torch.models.transformer import RUNTIME_LORA_KEY, transformer_forward
from s2v_torch.ops.quant import dense
from s2v_torch.schedulers import ddim
from s2v_torch.training import lora, optim
from s2v_torch.training.full import vpred_loss

# fp32 on both sides through 2 blocks; losses and grads differ only by the
# order of fp32 reductions: 1e-4 of the largest |value| of each compared array
REL_TO_MAX = 1e-4
# after Adam steps: Adam divides by sqrt(nu), which magnifies the relative
# error of grads near zero, so the bar is on the whole update's relative L2
UPDATE_REL_L2 = 1e-3
# with a bf16 first moment, grads that differ in their last fp32 bits can
# round a moment element to the neighbouring bf16 value, which moves that
# element's update by up to one bf16 ulp (2^-8 relative)
UPDATE_REL_L2_BF16_MOMENTS = 2.0 ** -8
ALPHAS = np.asarray(j_ddim.compute_alphas_cumprod(JSchedulerConfig()))


def _close_to_max(got, want, rel=REL_TO_MAX):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-12)
    assert np.abs(got - want).max() <= rel * scale, (np.abs(got - want).max(), scale)


def _base():
    cfg_j = JTransformerConfig.tiny()
    return cfg_j, perturb(init_transformer_params(jax.random.PRNGKey(0), cfg_j), seed=1)


def _batch(cfg_j, b=2, f=2, h=8, w=8, rope=True):
    c = cfg_j.in_channels
    batch = {
        "video_latents": rand(b, f, h, w, c, seed=2),
        "ref_latents": rand(b, 1, h, w, c, seed=3),
        "text_embeds": rand(b, cfg_j.max_text_seq_length, cfg_j.text_embed_dim, seed=4),
    }
    if rope:
        gh, gw = h // 2, w // 2
        cos, sin = get_3d_rotary_pos_embed(cfg_j.attention_head_dim, ((0, 0), (gh, gw)), (gh, gw), f + 1)
        tok = gh * gw
        cs, sn = build_segmented_rope(cfg_j.max_text_seq_length, cos[:tok], sin[:tok], cos[tok:], sin[tok:])
        batch["rope_cos"], batch["rope_sin"] = np.asarray(cs), np.asarray(sn)
    return batch


def _jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch_batch(batch):
    return {k: t(v) for k, v in batch.items()}


def _lora(base, spec, seed, b_scale=0.0):
    """The JAX init (A ~ N(0, 1/r), B = 0), with B optionally made nonzero so
    that A's grads are nonzero too."""
    tree = np_tree(j_lora.init_lora_params(jax.random.PRNGKey(seed), base, spec))
    rng = np.random.RandomState(seed)
    for ab in tree.values():
        ab["b"] = (ab["b"] + b_scale * rng.randn(*ab["b"].shape)).astype(np.float32)
    return tree


def _jax_draws(rng, shape):
    """The draws of s2v_tpu.training.full.vpred_loss (:69-71)."""
    k_t, k_n = jax.random.split(rng)
    ts = jax.random.randint(k_t, (shape[0],), 0, ALPHAS.shape[0])
    noise = jax.random.normal(k_n, shape, jnp.float32)
    return torch.from_numpy(np.asarray(ts)), t(noise)


def test_dense_with_lora_pairs_matches_jax():
    rng = np.random.RandomState(0)
    kernel, bias = rng.randn(12, 20).astype(np.float32), rng.randn(20).astype(np.float32)
    pairs = [(rng.randn(12, 3).astype(np.float32), rng.randn(3, 20).astype(np.float32)) for _ in range(2)]
    x = rng.randn(2, 5, 12).astype(np.float32)
    want = j_dense({"kernel": jnp.asarray(kernel), "bias": jnp.asarray(bias),
                    "lora": tuple((jnp.asarray(a), jnp.asarray(b)) for a, b in pairs)}, jnp.asarray(x))
    got = dense({"weight": t(kernel.T), "bias": t(bias), "lora": tuple((t(a), t(b)) for a, b in pairs)}, t(x))
    _close_to_max(got.numpy(), want)


def _runtime_tree(cfg_j, seed):
    """Nonzero factors on every runtime target: slotted to_q/to_k/to_v and the
    trainer's fused qkv together, the other block targets, both top targets."""
    rng = np.random.RandomState(seed)
    L, d, td, r = cfg_j.num_layers, cfg_j.inner_dim, cfg_j.time_embed_dim, 3
    pp_c = cfg_j.patch_size ** 2 * cfg_j.in_channels

    def pair(lead, d_in, d_out):
        return {"a": (0.1 * rng.randn(*lead, d_in, r)).astype(np.float32),
                "b": (0.1 * rng.randn(*lead, r, d_out)).astype(np.float32)}

    blocks = {name: pair((L,), d, d) for name in ("to_q", "to_k", "to_v", "to_out")}
    blocks["qkv"] = pair((L,), d, 3 * d)
    blocks["norm1.linear"] = pair((L,), td, 6 * d)
    blocks["norm2.linear"] = pair((L,), td, 6 * d)
    blocks["ff.net.2"] = pair((L,), 4 * d, d)
    top = {"patch_proj": pair((), pp_c, d), "text_proj": pair((), cfg_j.text_embed_dim, d)}
    return {"blocks": blocks, "top": top}


def test_forward_with_runtime_lora_matches_jax():
    cfg_j, base = _base()
    batch = _batch(cfg_j)
    tree = _runtime_tree(cfg_j, seed=5)
    ts = np.array([999, 500], np.int32)
    jb = _jax_batch(batch)
    want = j_forward({**base, J_RUNTIME_LORA_KEY: jax.tree.map(jnp.asarray, tree)}, cfg_j, jb["video_latents"],
                     jb["ref_latents"], jb["text_embeds"], jnp.asarray(ts), jb["rope_cos"], jb["rope_sin"])
    plain = j_forward(base, cfg_j, jb["video_latents"], jb["ref_latents"], jb["text_embeds"], jnp.asarray(ts),
                      jb["rope_cos"], jb["rope_sin"])
    assert np.abs(np.asarray(want) - np.asarray(plain)).max() > 1e-2  # the adapters matter
    cfg = TransformerConfig.tiny()
    params = transformer_from_jax(base, cfg, device="cpu")
    params[RUNTIME_LORA_KEY] = lora_from_jax(tree, device="cpu")
    tb = _torch_batch(batch)
    got = transformer_forward(params, cfg, tb["video_latents"], tb["ref_latents"], tb["text_embeds"],
                              torch.from_numpy(ts), tb["rope_cos"], tb["rope_sin"])
    _close_to_max(got.numpy(), want)


@pytest.mark.parametrize("backend", ["plain", "flash"])
def test_remat_grads_are_bit_identical(backend):
    cfg_j, base = _base()
    cfg = TransformerConfig.tiny()
    params = transformer_from_jax(base, cfg, device="cpu")
    spec = lora.LoRASpec(rank=4, alpha=8.0)
    tb = _torch_batch(_batch(cfg_j))
    ts, noise = torch.tensor([10, 900]), torch.from_numpy(rand(*tb["video_latents"].shape, seed=9))
    alphas = torch.from_numpy(ALPHAS)
    grads = []
    for remat in (False, True):
        tree = lora_from_jax(_lora(base, spec, seed=3, b_scale=0.1), device="cpu")
        leaves = lora.lora_leaves(tree)
        for x in leaves:
            x.requires_grad_(True)
        loss = lora.lora_loss_fn(tree, params, cfg, spec, tb, alphas, None, backend, remat, timesteps=ts, noise=noise)
        grads.append([loss] + list(torch.autograd.grad(loss, leaves)))
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_remat_modes():
    cfg_j, base = _base()
    cfg = TransformerConfig.tiny()
    params = transformer_from_jax(base, cfg, device="cpu")
    tb = _torch_batch(_batch(cfg_j, rope=False))
    args = (params, cfg, tb["video_latents"], tb["ref_latents"], tb["text_embeds"], torch.tensor([1, 2]))
    outs = [transformer_forward(*args, remat=m) for m in (False, "none", True, "full")]
    for o in outs[1:]:
        assert torch.equal(o, outs[0])
    for mode in ("dots", "seg", "seg2"):
        with pytest.raises(NotImplementedError):
            transformer_forward(*args, remat=mode)
    with pytest.raises(ValueError):
        transformer_forward(*args, remat="sometimes")


def test_vpred_loss_matches_jax():
    cfg_j, base = _base()
    batch = _batch(cfg_j)
    rng = jax.random.PRNGKey(7)
    want = j_vpred_loss(base, cfg_j, _jax_batch(batch), jnp.asarray(ALPHAS), rng, remat=False)
    ts, noise = _jax_draws(rng, batch["video_latents"].shape)
    cfg = TransformerConfig.tiny()
    got = vpred_loss(transformer_from_jax(base, cfg, device="cpu"), cfg, _torch_batch(batch),
                     torch.from_numpy(ALPHAS), remat=False, timesteps=ts, noise=noise)
    _close_to_max(got.item(), float(want))
    # drawn from a generator: timesteps in range, finite loss, reproducible
    g1, g2 = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    params = transformer_from_jax(base, cfg, device="cpu")
    a = vpred_loss(params, cfg, _torch_batch(batch), torch.from_numpy(ALPHAS), g1, remat=False)
    b = vpred_loss(params, cfg, _torch_batch(batch), torch.from_numpy(ALPHAS), g2, remat=False)
    assert torch.isfinite(a) and torch.equal(a, b)


def test_vpred_loss_compute_dtype_matches_jax():
    """fp32 master params cast to bf16 for a bf16 model config's forward, in
    both packages; the grads come back in the master dtype."""
    _, base = _base()
    cfg_j = JTransformerConfig.tiny(dtype=jnp.bfloat16)
    batch = _batch(cfg_j)
    rng = jax.random.PRNGKey(8)
    want = j_vpred_loss(base, cfg_j, _jax_batch(batch), jnp.asarray(ALPHAS), rng, remat=False,
                        compute_dtype=jnp.bfloat16)
    ts, noise = _jax_draws(rng, batch["video_latents"].shape)
    cfg = TransformerConfig.tiny(dtype=torch.bfloat16)
    params = transformer_from_jax(base, TransformerConfig.tiny(), device="cpu")  # fp32 master
    leaf = params["blocks"][0]["attn"]["qkv"]["weight"].requires_grad_()
    got = vpred_loss(params, cfg, _torch_batch(batch), torch.from_numpy(ALPHAS), remat=False,
                     compute_dtype=torch.bfloat16, timesteps=ts, noise=noise)
    assert got.dtype == torch.float32 and torch.autograd.grad(got, leaf)[0].dtype == torch.float32
    # bf16 weights and activations round in other places in the two
    # frameworks; the mean over ~2k squared errors averages those roundings
    # (2^-8 each) down to ~3e-4 of the loss over three seeds
    np.testing.assert_allclose(got.item(), float(want), rtol=2e-3)
    with pytest.raises(ValueError):
        vpred_loss(params, TransformerConfig.tiny(), _torch_batch(batch), torch.from_numpy(ALPHAS),
                   compute_dtype=torch.bfloat16, timesteps=ts, noise=noise)


@pytest.mark.parametrize("backend", ["flash", "plain"])
def test_lora_loss_fn_value_and_grads_match_jax(backend):
    cfg_j, base = _base()
    batch = _batch(cfg_j)
    spec = j_lora.LoRASpec(rank=4, alpha=8.0)
    tree = _lora(base, spec, seed=3, b_scale=0.1)
    rng = jax.random.PRNGKey(11)
    loss_j, grads_j = jax.value_and_grad(j_lora.lora_loss_fn)(
        jax.tree.map(jnp.asarray, tree), base, cfg_j, spec, _jax_batch(batch), jnp.asarray(ALPHAS), rng, "xla", True)
    ts, noise = _jax_draws(rng, batch["video_latents"].shape)
    cfg = TransformerConfig.tiny()
    mine = lora_from_jax(tree, device="cpu")
    leaves = lora.lora_leaves(mine)
    for x in leaves:
        x.requires_grad_(True)
    loss = lora.lora_loss_fn(mine, transformer_from_jax(base, cfg, device="cpu"), cfg,
                             lora.LoRASpec(rank=4, alpha=8.0), _torch_batch(batch), torch.from_numpy(ALPHAS),
                             None, backend, True, timesteps=ts, noise=noise)
    grads = dict(zip([(n, k) for n in sorted(mine) for k in ("a", "b")], torch.autograd.grad(loss, leaves)))
    _close_to_max(loss.item(), float(loss_j))
    for (name, k), g in grads.items():
        _close_to_max(g.numpy(), np.asarray(grads_j[name][k]))


SPECS = {
    "adamw": dict(),
    "adamw_bf16_moments": dict(moment_dtype="bfloat16"),
    "adam": dict(optimizer="adam"),
    "max_grad_norm_1": dict(max_grad_norm=1.0),
    "accumulate_2": dict(gradient_accumulation_steps=2),
    "cosine_warmup": dict(lr_scheduler="cosine", lr_warmup_steps=2, max_train_steps=6),
}


@pytest.mark.parametrize("name", list(SPECS))
def test_train_steps_match_jax(name):
    """Three train steps of both packages from the same adapters, batch and
    draws.  The grads' global norm here is ~1.7, so a limit of 1.0 engages
    the clip; ``learning_rate`` 1e-2 makes each update visible."""
    cfg_j, base = _base()
    batch = _batch(cfg_j)
    kw = dict(learning_rate=1e-2, **SPECS[name])
    spec_j, spec = j_lora.LoRASpec(rank=4, alpha=8.0), lora.LoRASpec(rank=4, alpha=8.0)
    tree = _lora(base, spec_j, seed=3, b_scale=0.1)
    init_j, step_j = j_lora.make_lora_train_step(base, cfg_j, spec_j, remat=False,
                                                 optimizer_spec=j_optim.OptimizerSpec(**kw))
    cfg = TransformerConfig.tiny()
    init, step = lora.make_lora_train_step(transformer_from_jax(base, cfg, device="cpu"), cfg, spec,
                                           remat=False, optimizer_spec=optim.OptimizerSpec(**kw))
    lj = jax.tree.map(jnp.asarray, tree)
    sj = init_j(lj)
    mine = lora_from_jax(tree, device="cpu")
    state = init(mine)
    jb, tb = _jax_batch(batch), _torch_batch(batch)
    for i in range(3):
        rng = jax.random.PRNGKey(100 + i)
        ts, noise = _jax_draws(rng, batch["video_latents"].shape)
        lj, sj, loss_j = step_j(lj, sj, jb, rng)
        mine, state, loss = step(mine, state, tb, timesteps=ts, noise=noise)
        _close_to_max(loss.item(), float(loss_j))
    for target in tree:
        for k in ("a", "b"):
            start = tree[target][k]
            want = np.asarray(lj[target][k]) - start
            got = mine[target][k].detach().numpy() - start
            assert np.abs(want).max() > 0 or k == "a"
            bar = UPDATE_REL_L2_BF16_MOMENTS if kw.get("moment_dtype") == "bfloat16" else UPDATE_REL_L2
            assert np.linalg.norm(got - want) <= bar * max(np.linalg.norm(want), 1e-12), (target, k)


@pytest.mark.parametrize("kw", [
    dict(lr_scheduler="constant"),
    dict(lr_scheduler="constant_with_warmup", lr_warmup_steps=5),
    dict(lr_scheduler="constant_with_warmup", lr_warmup_steps=0),
    dict(lr_scheduler="linear", lr_warmup_steps=4, max_train_steps=15),
    dict(lr_scheduler="linear", max_train_steps=12),
    dict(lr_scheduler="cosine", lr_warmup_steps=3, max_train_steps=16),
    dict(lr_scheduler="cosine", max_train_steps=10),
], ids=lambda kw: "-".join(str(v) for v in kw.values()))
def test_lr_schedule_matches_optax(kw):
    want = j_optim.make_lr_schedule(j_optim.OptimizerSpec(learning_rate=3e-4, **kw))
    got = optim.make_lr_schedule(optim.OptimizerSpec(learning_rate=3e-4, **kw))
    for step in range(21):
        # optax schedules compute in fp32
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6, atol=1e-12)


def test_optimizer_spec_validation():
    for bad in (dict(optimizer="sgd"), dict(lr_scheduler="step"), dict(gradient_accumulation_steps=0),
                dict(moment_dtype="float16"), dict(optimizer="prodigy", moment_dtype="bfloat16")):
        with pytest.raises(ValueError):
            optim.OptimizerSpec(**bad)
    with pytest.raises(NotImplementedError):
        optim.make_optimizer(optim.OptimizerSpec(optimizer="prodigy"))


def test_unported_lora_modes_raise():
    cfg_j, base = _base()
    params = transformer_from_jax(base, TransformerConfig.tiny(), device="cpu")
    with pytest.raises(NotImplementedError):
        lora.init_lora_params(torch.Generator(), params, lora.LoRASpec(disentangled=True))
    # QLoRA is ported (tests/test_torch_qlora.py); on an int8 base the
    # disentangled mode is refused outright, as in the JAX package
    from s2v_torch.ops.quant import quantize_transformer_params

    with pytest.raises(ValueError, match="disentangled"):
        lora.init_lora_params(torch.Generator(), quantize_transformer_params(params), lora.LoRASpec(disentangled=True))


def test_init_and_merge_match_jax_layout():
    cfg_j, base = _base()
    cfg = TransformerConfig.tiny()
    params = transformer_from_jax(base, cfg, device="cpu")
    spec = lora.LoRASpec(rank=4, alpha=8.0)
    mine = lora.init_lora_params(torch.Generator().manual_seed(0), params, spec)
    theirs = _lora(base, j_lora.LoRASpec(rank=4, alpha=8.0), seed=0)
    for name in theirs:
        for k in ("a", "b"):
            assert tuple(mine[name][k].shape) == theirs[name][k].shape and mine[name][k].dtype == torch.float32
        assert not mine[name]["b"].any()
    # the functional merge equals the JAX merge, carried across
    tree = _lora(base, j_lora.LoRASpec(rank=4, alpha=8.0), seed=4, b_scale=0.1)
    want = transformer_from_jax(np_tree(j_lora.merge_lora_params(base, jax.tree.map(jnp.asarray, tree),
                                                                 j_lora.LoRASpec(rank=4, alpha=8.0))), cfg, "cpu")
    got = lora.merge_lora_params(params, lora_from_jax(tree, device="cpu"), spec)
    flat = lambda p: jax.tree.leaves(jax.tree.map(lambda x: x.numpy(), p))  # noqa: E731
    for a, b in zip(flat(got), flat(want)):
        _close_to_max(a, b)


def test_export_and_runtime_tree_match_jax():
    cfg_j, base = _base()
    spec_j = j_lora.LoRASpec(rank=4, alpha=8.0)
    tree = _lora(base, spec_j, seed=6, b_scale=0.1)
    mine = lora_from_jax(tree, device="cpu")
    spec = lora.LoRASpec(rank=4, alpha=8.0)
    want = j_lora.export_lora_to_reference_format(tree, spec_j, cfg_j)
    got = lora.export_lora_to_reference_format(mine, spec, TransformerConfig.tiny())
    assert sorted(got) == sorted(want) and len(got) == 2 * (5 * cfg_j.num_layers + 2 * cfg_j.num_layers + 2)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])
    want_rt = j_lora.runtime_tree_from_training(tree, spec_j)
    got_rt = lora.runtime_tree_from_training(mine, spec)
    assert jax.tree.structure(got_rt) == jax.tree.structure(want_rt)
    for a, b in zip(jax.tree.leaves(got_rt), jax.tree.leaves(want_rt)):
        np.testing.assert_array_equal(a, b)


def test_lora_from_jax_round_trip():
    cfg_j, base = _base()
    tree = _lora(base, j_lora.LoRASpec(rank=4, alpha=8.0), seed=2, b_scale=0.1)
    for nested in (tree, {"blocks": {"qkv": tree["qkv"]}, "top": {"text_proj": tree["text_proj"]}}):
        got = lora_from_jax(nested, device="cpu")
        back = jax.tree.map(lambda x: x.numpy(), got)
        assert jax.tree.structure(back) == jax.tree.structure(nested)
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(nested)):
            assert a.dtype == np.float32
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("fn", ["add_noise", "get_velocity"])
def test_device_timesteps_match_host_and_jax(fn):
    """A timestep tensor indexes the table where it lies; host ints and
    numpy arrays still work; all agree with the JAX function."""
    x, noise = rand(3, 2, 4, 4, 2, seed=1), rand(3, 2, 4, 4, 2, seed=2)
    ts = np.array([0, 437, 999])
    want = np.asarray(getattr(j_ddim, fn)(jnp.asarray(x), jnp.asarray(noise), jnp.asarray(ALPHAS), jnp.asarray(ts)))
    f = getattr(ddim, fn)
    for timesteps, table in ((torch.from_numpy(ts), ALPHAS), (torch.from_numpy(ts), torch.from_numpy(ALPHAS)),
                             (ts, ALPHAS), (list(ts), ALPHAS)):
        np.testing.assert_allclose(f(t(x), t(noise), table, timesteps).numpy(), want, rtol=1e-6, atol=1e-6)
    one = f(t(x), t(noise), ALPHAS, 437)
    np.testing.assert_allclose(one[1].numpy(), want[1], rtol=1e-6, atol=1e-6)


class _StubTokenizer:
    """Deterministic ids from the prompt's bytes (the same object is handed
    to both packages, so the tokenizer is not what is compared here)."""

    def encode(self, prompts, max_length):
        out = np.zeros((len(prompts), max_length), np.int32)
        for i, p in enumerate(prompts):
            ids = [2 + (ord(c) % 100) for c in p][: max_length - 1] + [1]
            out[i, :len(ids)] = ids
        return out


def _tiny_data_pipes():
    from types import SimpleNamespace

    from s2v_tpu.config import T5Config as JT5Config, VAEConfig as JVAEConfig
    from s2v_tpu.models.t5 import init_t5_params
    from s2v_tpu.models.vae import init_vae_params
    from s2v_torch.config import T5Config, VAEConfig
    from s2v_torch.loaders.jax_params import t5_from_jax, vae_from_jax

    vcfg_j = JVAEConfig.tiny(latent_channels=4, sample_height=64, sample_width=64)
    t5cfg_j = JT5Config.tiny()
    vae = perturb(init_vae_params(jax.random.PRNGKey(1), vcfg_j), seed=4, scale=0.02)
    t5 = perturb(init_t5_params(jax.random.PRNGKey(2), t5cfg_j), seed=5, scale=0.05)
    tcfg_j = JTransformerConfig.tiny()
    pipe_j = SimpleNamespace(vae_params=vae, vae_cfg=vcfg_j, t5_params=t5, t5_cfg=t5cfg_j,
                             tokenizer=_StubTokenizer(), transformer_cfg=tcfg_j)
    vcfg, t5cfg = VAEConfig.tiny(latent_channels=4, sample_height=64, sample_width=64), T5Config.tiny()
    pipe = SimpleNamespace(vae_params=vae_from_jax(vae, vcfg, device="cpu"), vae_cfg=vcfg,
                           t5_params=t5_from_jax(t5, t5cfg, device="cpu"), t5_cfg=t5cfg,
                           tokenizer=_StubTokenizer(), transformer_cfg=TransformerConfig.tiny(),
                           device=torch.device("cpu"))
    rng = np.random.RandomState(8)
    dataset = [{"video": np.clip(rng.randn(5, 16, 16, 3) * 0.5, -1, 1).astype(np.float32),
                "ref_image": np.clip(rng.randn(16, 16, 3) * 0.5, -1, 1).astype(np.float32),
                "prompt": p} for p in ("a pig", "a dog running", "a cat")]
    return pipe_j, pipe, dataset


def test_latent_batches_match_jax(tmp_path):
    from s2v_tpu.training.data import latent_batches as j_latent_batches
    from s2v_torch.training.data import latent_batches

    pipe_j, pipe, dataset = _tiny_data_pipes()
    want = list(j_latent_batches(dataset, pipe_j, batch_size=1, seed=4, rng_noise=False))
    got = list(latent_batches(dataset, pipe, batch_size=1, seed=4, rng_noise=False))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        for key in ("video_latents", "ref_latents", "text_embeds"):
            # fp32 through the tiny VAE encoder / T5 (tests/test_torch_vae.py's bar)
            np.testing.assert_allclose(g[key].numpy(), np.asarray(w[key]), atol=1e-4, rtol=1e-4)
    # the disk cache: a second, restarted run reads the entries the first wrote
    cache_dir = str(tmp_path / "cache")
    first = list(latent_batches(dataset, pipe, seed=4, cache={}, cache_dir=cache_dir))
    assert len(list(tmp_path.joinpath("cache").glob("*.npz"))) == 3
    pipe.vae_params = None  # an encode now would fail: every item must come from disk
    second = list(latent_batches(dataset, pipe, seed=4, cache={}, cache_dir=cache_dir))
    for a, b in zip(first, second):
        for key in a:
            assert torch.equal(a[key], b[key])


def test_prefetch_batches_passes_items_and_errors():
    from s2v_torch.training.data import prefetch_batches

    assert list(prefetch_batches(iter(range(7)), depth=2)) == list(range(7))

    def boom():
        yield 1
        raise RuntimeError("producer failed")

    it = prefetch_batches(boom())
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="producer failed"):
        next(it)
