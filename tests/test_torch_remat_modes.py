"""Remat modes of the DiT (``s2v_torch/models/transformer.py``, the
counterpart of ``s2v_tpu/models/transformer.py:465-509``): ``dots`` (each
block checkpointed with a selective policy that keeps the linears' outputs)
and ``seg``/``seg<N>`` (nested checkpoints over segments of blocks).

On a tiny 4-block DiT in fp32, the LoRA loss and every adapter gradient
under each mode equal those without remat bit for bit (the recomputation
runs the same ops on the same inputs), with the plain attention and with the
``flash`` backend's autograd function (B1/B2's plain versions on the CPU),
and the loss equals the JAX package's under the same mode within 1e-4 of
its magnitude (fp32 reductions in another order)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from _torch_parity import np_tree, perturb, rand, t
from s2v_tpu.config import SchedulerConfig as JSchedulerConfig
from s2v_tpu.config import TransformerConfig as JTransformerConfig
from s2v_tpu.models.transformer import init_transformer_params
from s2v_tpu.schedulers import ddim as j_ddim
from s2v_tpu.training import lora as j_lora
from s2v_torch.config import TransformerConfig
from s2v_torch.loaders.jax_params import lora_from_jax, transformer_from_jax
from s2v_torch.models.transformer import _remat_plan, transformer_forward
from s2v_torch.training import lora

LAYERS = 4
REL_TO_MAX = 1e-4
ALPHAS = np.asarray(j_ddim.compute_alphas_cumprod(JSchedulerConfig()))
RNG = jax.random.PRNGKey(100)


def _setup():
    cfg_j = JTransformerConfig.tiny(num_layers=LAYERS)
    base = perturb(init_transformer_params(jax.random.PRNGKey(0), cfg_j), seed=1)
    c = cfg_j.in_channels
    batch = {"video_latents": rand(1, 2, 8, 8, c, seed=2), "ref_latents": rand(1, 1, 8, 8, c, seed=3),
             "text_embeds": rand(1, cfg_j.max_text_seq_length, cfg_j.text_embed_dim, seed=4)}
    spec_j = j_lora.LoRASpec(rank=4, alpha=8.0)
    tree = np_tree(j_lora.init_lora_params(jax.random.PRNGKey(3), base, spec_j))
    rng = np.random.RandomState(3)
    for ab in tree.values():
        ab["b"] = (ab["b"] + 0.1 * rng.randn(*ab["b"].shape)).astype(np.float32)
    return cfg_j, base, batch, spec_j, tree


def _jax_draws(shape):
    """The draws ``s2v_tpu.training.full.vpred_loss`` makes from RNG (:69-71)."""
    k_t, k_n = jax.random.split(RNG)
    ts = jax.random.randint(k_t, (shape[0],), 0, ALPHAS.shape[0])
    return torch.from_numpy(np.asarray(ts)), t(jax.random.normal(k_n, shape, jnp.float32))


def _loss_and_grads(params, cfg, tree, batch, remat, backend):
    spec = lora.LoRASpec(rank=4, alpha=8.0)
    ts, noise = _jax_draws(batch["video_latents"].shape)
    mine = lora_from_jax(tree, device="cpu")
    leaves = lora.lora_leaves(mine)
    for x in leaves:
        x.requires_grad_(True)
    tb = {k: t(v) for k, v in batch.items()}
    loss = lora.lora_loss_fn(mine, params, cfg, spec, tb, torch.from_numpy(ALPHAS), None, backend, remat,
                             timesteps=ts, noise=noise)
    return [loss.detach()] + list(torch.autograd.grad(loss, leaves))


@pytest.mark.parametrize("backend", ["plain", "flash"])
@pytest.mark.parametrize("mode", ["dots", "seg", "seg1", "seg4"])
def test_remat_mode_grads_equal_no_remat(mode, backend):
    cfg_j, base, batch, spec_j, tree = _setup()
    cfg = TransformerConfig.tiny(num_layers=LAYERS)
    params = transformer_from_jax(base, cfg, device="cpu")
    want = _loss_and_grads(params, cfg, tree, batch, False, backend)
    got = _loss_and_grads(params, cfg, tree, batch, mode, backend)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("mode", ["dots", "seg2"])
def test_remat_mode_loss_matches_jax(mode):
    cfg_j, base, batch, spec_j, tree = _setup()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    cfg = TransformerConfig.tiny(num_layers=LAYERS)
    got = _loss_and_grads(transformer_from_jax(base, cfg, device="cpu"), cfg, tree, batch, mode, "plain")
    want = float(j_lora.lora_loss_fn(jax.tree.map(jnp.asarray, tree), jax.tree.map(jnp.asarray, base), cfg_j,
                                     spec_j, jb, jnp.asarray(ALPHAS), RNG, remat=mode))
    assert abs(got[0].item() - want) <= REL_TO_MAX * abs(want)


def test_seg_picks_the_segment_count_and_refuses_a_non_divisor():
    """``seg`` minimises S + L/S (ties to the smaller S, as JAX's ``min``);
    ``seg<N>`` pins N and raises JAX's ValueError when N does not divide L."""
    assert _remat_plan("seg", 42) == ("seg", 6)  # the 5b DiT: 6 + 7 = 13
    assert _remat_plan("seg", 30) == ("seg", 5)  # the 2b DiT: 5 + 6 = 11
    assert _remat_plan("seg", 4) == ("seg", 2)
    assert _remat_plan("seg7", 42) == ("seg", 7)
    assert _remat_plan("dots", 42) == ("dots", 0)
    cfg = TransformerConfig.tiny(num_layers=LAYERS)
    params = transformer_from_jax(perturb(init_transformer_params(jax.random.PRNGKey(0),
                                                                  JTransformerConfig.tiny(num_layers=LAYERS)), 1),
                                  cfg, device="cpu")
    x = torch.zeros(1, 2, 8, 8, cfg.in_channels)
    with pytest.raises(ValueError, match="3 does not divide 4 layers"):
        transformer_forward(params, cfg, x, x[:, :1], torch.zeros(1, cfg.max_text_seq_length, cfg.text_embed_dim),
                            torch.tensor([1]), remat="seg3")
