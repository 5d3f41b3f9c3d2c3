"""QLoRA in the port (LoRA adapters over a frozen int8 base) against the
JAX package's (``tests/test_training.py``'s QLoRA tests, on the same
inputs): gradients through the int8 linears, the loss and grads, the modes
an int8 base refuses, runtime factors over int8 against a bf16 merge, and
train steps.  The base is the JAX package's quantization of a perturbed
tiny DiT, carried across; the JAX draws (timesteps, noise) are handed to the
port through its ``timesteps=``/``noise=`` hooks."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from _torch_parity import np_tree, quantized
from s2v_tpu.models.transformer import RUNTIME_LORA_KEY as J_RUNTIME_LORA_KEY
from s2v_tpu.models.transformer import transformer_forward as j_forward
from s2v_tpu.training import lora as j_lora
from s2v_torch.config import TransformerConfig
from s2v_torch.loaders.jax_params import lora_from_jax, transformer_from_jax
from s2v_torch.models.transformer import RUNTIME_LORA_KEY, transformer_forward
from s2v_torch.ops.quant import quantize_transformer_params
from s2v_torch.training import lora
from test_torch_training import ALPHAS, _base, _batch, _jax_batch, _jax_draws, _lora, _torch_batch

# fp32 on both sides through 2 blocks of int8 linears.  The int8 values
# agree unless a last-bit difference upstream (summation order) moves one
# activation across a rounding boundary and flips it by one int8 step.  The
# loss and outputs then move by up to ~3e-4 of their largest value: 1e-3
# allows a few flips.  The grads move more: the backward also rounds
# g·w_scale to bf16 (as the JAX package does), so a last-bit difference in
# g can flip that rounding by one bf16 ulp (2^-8) too.  Measured here over
# three seeds: grads agree to ~1e-4 of their largest element without a
# forward flip, to at most ~4e-3 with one, and to 5e-7 with both roundings
# taken out.  1e-2 allows the flips; a wrong layout, scale or a stopped
# straight-through backward moves the grads by tens of percents or to zero.
QLORA_REL_TO_MAX = 1e-3
QLORA_GRAD_REL_TO_MAX = 1e-2
SPEC_KW = dict(rank=4, alpha=8.0)


def _close_to_max(got, want, rel=QLORA_REL_TO_MAX):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-12)
    assert np.abs(got - want).max() <= rel * scale, (np.abs(got - want).max(), scale)


def _qbase():
    cfg_j, base = _base()
    qbase = quantized(base)
    return cfg_j, base, qbase, transformer_from_jax(qbase, TransformerConfig.tiny(), device="cpu")


def _grads(tree, params, spec, batch, ts, noise, backend="plain", remat=True):
    leaves = lora.lora_leaves(tree)
    for x in leaves:
        x.requires_grad_(True)
    loss = lora.lora_loss_fn(tree, params, TransformerConfig.tiny(), spec, batch, torch.from_numpy(ALPHAS), None,
                             backend, remat, timesteps=ts, noise=noise)
    grads = torch.autograd.grad(loss, leaves)
    return loss, dict(zip([(n, k) for n in sorted(tree) for k in ("a", "b")], grads))


@pytest.mark.parametrize("backend", ["plain", "flash"])
def test_qlora_gradients_flow_through_int8_layers(backend):
    """``round`` has a zero gradient: without the straight-through backward
    the layer-0 adapters (whose path to the loss crosses every later int8
    linear) would get exactly zero.  B = 0 at init, so the B grads carry it."""
    cfg_j, base, _, params = _qbase()
    spec = lora.LoRASpec(**SPEC_KW)
    tree = lora_from_jax(_lora(base, j_lora.LoRASpec(**SPEC_KW), seed=1), device="cpu")
    batch = _batch(cfg_j)
    ts, noise = _jax_draws(jax.random.PRNGKey(5), batch["video_latents"].shape)
    _, grads = _grads(tree, params, spec, _torch_batch(batch), ts, noise, backend)
    assert grads[("qkv", "b")][0].abs().max() > 0, "layer-0 grad is zero: the int8 backward is broken"
    assert grads[("norm1.linear", "b")][0].abs().max() > 0
    assert grads[("patch_proj", "b")].abs().max() > 0


def test_qlora_loss_and_grads_match_jax():
    cfg_j, base, qbase, params = _qbase()
    spec_j = j_lora.LoRASpec(**SPEC_KW)
    tree = _lora(base, spec_j, seed=3, b_scale=0.1)
    batch = _batch(cfg_j)
    rng = jax.random.PRNGKey(7)
    loss_j, grads_j = jax.value_and_grad(j_lora.lora_loss_fn)(
        jax.tree.map(jnp.asarray, tree), jax.tree.map(jnp.asarray, qbase), cfg_j, spec_j, _jax_batch(batch),
        jnp.asarray(ALPHAS), rng, "xla", True)
    ts, noise = _jax_draws(rng, batch["video_latents"].shape)
    loss, grads = _grads(lora_from_jax(tree, device="cpu"), params, lora.LoRASpec(**SPEC_KW), _torch_batch(batch),
                         ts, noise)
    _close_to_max(loss.item(), float(loss_j))
    for (name, k), g in grads.items():
        _close_to_max(g.numpy(), np.asarray(grads_j[name][k]), QLORA_GRAD_REL_TO_MAX)
    # and it is the int8 base, not the fp32 one (the JAX test's bar: within 5%)
    loss_fp32, _ = _grads(lora_from_jax(tree, device="cpu"), transformer_from_jax(base, TransformerConfig.tiny(), "cpu"),
                          lora.LoRASpec(**SPEC_KW), _torch_batch(batch), ts, noise)
    assert 1e-7 < abs(loss.item() / loss_fp32.item() - 1) < 0.05


def test_qlora_rejects_merge_and_disentangled():
    cfg_j, base, qbase, params = _qbase()
    tree = lora_from_jax(_lora(base, j_lora.LoRASpec(**SPEC_KW), seed=2), device="cpu")
    with pytest.raises(ValueError, match="bf16/fp32 base"):
        lora.merge_lora_params(params, tree, lora.LoRASpec(**SPEC_KW))
    dspec = lora.LoRASpec(disentangled=True, **SPEC_KW)
    with pytest.raises(ValueError, match="disentangled"):
        lora.make_lora_train_step(params, TransformerConfig.tiny(), dspec)
    with pytest.raises(ValueError, match="disentangled"):
        lora.init_lora_params(torch.Generator(), params, dspec)
    # the JAX package refuses the same two
    with pytest.raises(ValueError, match="bf16/fp32 base"):
        j_lora.merge_lora_params(jax.tree.map(jnp.asarray, qbase), jax.tree.map(jnp.asarray, np_tree(tree)),
                                 j_lora.LoRASpec(**SPEC_KW))


def test_qlora_init_takes_shapes_from_q():
    cfg_j, base, _, params = _qbase()
    spec = lora.LoRASpec(**SPEC_KW)
    mine = lora.init_lora_params(torch.Generator().manual_seed(0), params, spec)
    theirs = _lora(base, j_lora.LoRASpec(**SPEC_KW), seed=0)
    for name in theirs:
        for k in ("a", "b"):
            assert tuple(mine[name][k].shape) == theirs[name][k].shape
        assert not mine[name]["b"].any()


def test_runtime_factors_over_int8_match_bf16_merge():
    """The int8 base with the adapters as runtime factors ≈ the fp32 base
    with them merged (the JAX test's 5%), and equal to the JAX package's
    int8 + runtime forward (the flip-tolerant bar above)."""
    cfg_j, base, qbase, _ = _qbase()
    spec = lora.LoRASpec(**SPEC_KW)
    tree = jax.tree.map(lambda x: x + np.float32(0.05), _lora(base, j_lora.LoRASpec(**SPEC_KW), seed=4))
    cfg = TransformerConfig.tiny()
    fp32 = transformer_from_jax(base, cfg, device="cpu")
    merged = lora.merge_lora_params(fp32, lora_from_jax(tree, device="cpu"), spec)
    runtime = lora.runtime_tree_from_training(tree, spec)
    qtree = {**quantize_transformer_params(fp32), RUNTIME_LORA_KEY: lora_from_jax(runtime, device="cpu")}
    batch = _batch(cfg_j, rope=False)
    tb = _torch_batch(batch)
    ts = np.array([100, 500], np.int32)
    args = (tb["video_latents"], tb["ref_latents"], tb["text_embeds"], torch.from_numpy(ts))
    out_merged = transformer_forward(merged, cfg, *args).numpy()
    out_q = transformer_forward(qtree, cfg, *args).numpy()
    assert np.abs(out_q - out_merged).max() / np.abs(out_merged).max() < 0.05
    want = j_forward({**jax.tree.map(jnp.asarray, qbase), J_RUNTIME_LORA_KEY: jax.tree.map(jnp.asarray, runtime)},
                     cfg_j, *(jnp.asarray(batch[k]) for k in ("video_latents", "ref_latents", "text_embeds")),
                     jnp.asarray(ts))
    _close_to_max(out_q, np.asarray(want))


def test_qlora_train_steps_match_jax_and_reduce_loss():
    """Four steps at lr 1e-2 on the same draws each step (the JAX test
    reuses one key): the port's losses are the JAX losses, and they fall."""
    cfg_j, base, qbase, params = _qbase()
    spec_j, spec = j_lora.LoRASpec(**SPEC_KW), lora.LoRASpec(**SPEC_KW)
    tree = _lora(base, spec_j, seed=1)
    batch = _batch(cfg_j)
    init_j, step_j = j_lora.make_lora_train_step(jax.tree.map(jnp.asarray, qbase), cfg_j, spec_j,
                                                 learning_rate=1e-2)
    init, step = lora.make_lora_train_step(params, TransformerConfig.tiny(), spec, learning_rate=1e-2)
    lj = jax.tree.map(jnp.asarray, tree)
    sj = init_j(lj)
    mine = lora_from_jax(tree, device="cpu")
    state = init(mine)
    before = [x.clone() for layer in params["blocks"] for x in (layer["attn"]["qkv"]["q"], layer["ff"]["net_0"]["scale"])]
    rng = jax.random.PRNGKey(0)
    ts, noise = _jax_draws(rng, batch["video_latents"].shape)
    jb, tb = _jax_batch(batch), _torch_batch(batch)
    losses, losses_j = [], []
    for _ in range(4):
        lj, sj, loss_j = step_j(lj, sj, jb, rng)
        mine, state, loss = step(mine, state, tb, timesteps=ts, noise=noise)
        losses.append(loss.item())
        losses_j.append(float(loss_j))
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    _close_to_max(losses, losses_j)
    after = [x for layer in params["blocks"] for x in (layer["attn"]["qkv"]["q"], layer["ff"]["net_0"]["scale"])]
    assert all(torch.equal(a, b) for a, b in zip(before, after))  # the int8 base is frozen
    assert after[0].dtype == torch.int8

