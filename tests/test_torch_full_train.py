"""Full fine-tuning on one card (``s2v_torch/training/full.py::
make_full_train_step``) against the JAX package's with no mesh
(``s2v_tpu/training/full.py:153-280``), on the tiny DiT: the same fp32
master weights, batch and draws (the JAX step's timesteps and noise,
reproduced from its rng and handed to the port's hooks).

Tolerances: fp32 forward, losses to 1e-4 of their magnitude and the
weights' and EMA's movement to 1e-3 relative L2 (Adam divides by sqrt(nu),
which magnifies the fp32 reduction-order differences of near-zero grads);
bf16 forward (both configs in bf16, the fp32 master cast for the forward),
losses to 2e-2 relative (bf16 activations in two frameworks' op orders) and
the movement to 1e-1 relative L2: Adam divides each gradient by its own
running RMS, so an entry whose gradient is mostly bf16 rounding still moves
by the full step, in either direction (measured 5.7e-2 at block 0's qkv)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from _torch_parity import perturb, rand
from s2v_tpu.config import TransformerConfig as JTransformerConfig
from s2v_tpu.models.transformer import init_transformer_params
from s2v_tpu.schedulers import ddim as j_ddim
from s2v_tpu.config import SchedulerConfig as JSchedulerConfig
from s2v_tpu.training import full as j_full
from s2v_tpu.training import optim as j_optim
from s2v_tpu.ops.rope import build_segmented_rope, get_3d_rotary_pos_embed
from s2v_torch.config import TransformerConfig
from s2v_torch.loaders.jax_params import transformer_from_jax
from s2v_torch.training import optim
from s2v_torch.training.full import floating_leaves, make_full_train_step

ALPHAS = np.asarray(j_ddim.compute_alphas_cumprod(JSchedulerConfig()))
TOLS = {"float32": (1e-4, 1e-3), "bfloat16": (2e-2, 1e-1)}


def _batch(cfg_j):
    c = cfg_j.in_channels
    batch = {"video_latents": rand(1, 2, 8, 8, c, seed=2), "ref_latents": rand(1, 1, 8, 8, c, seed=3),
             "text_embeds": rand(1, cfg_j.max_text_seq_length, cfg_j.text_embed_dim, seed=4)}
    cos, sin = get_3d_rotary_pos_embed(cfg_j.attention_head_dim, ((0, 0), (4, 4)), (4, 4), 3)
    cs, sn = build_segmented_rope(cfg_j.max_text_seq_length, cos[:16], sin[:16], cos[16:], sin[16:])
    batch["rope_cos"], batch["rope_sin"] = np.asarray(cs), np.asarray(sn)
    return batch


def _draws(rng, shape):
    k_t, k_n = jax.random.split(rng)
    ts = jax.random.randint(k_t, (shape[0],), 0, ALPHAS.shape[0])
    return torch.from_numpy(np.asarray(ts)), torch.from_numpy(np.asarray(jax.random.normal(k_n, shape, jnp.float32)))


CASES = {
    "adamw": (dict(), 0.0, "float32"),
    "ema_accumulate_2": (dict(gradient_accumulation_steps=2, max_grad_norm=1.0), 0.9, "float32"),
    "bf16_compute_ema": (dict(), 0.9, "bfloat16"),
}


@pytest.mark.parametrize("name", list(CASES))
def test_full_train_steps_match_jax(name):
    kw, ema_decay, compute = CASES[name]
    steps = 4
    dt_j = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[compute]
    cfg_j = JTransformerConfig.tiny(dtype=dt_j)
    base = perturb(init_transformer_params(jax.random.PRNGKey(0), JTransformerConfig.tiny()), seed=1)
    spec_kw = dict(learning_rate=1e-3, **kw)
    prep_j, init_j, step_j = j_full.make_full_train_step(
        cfg_j, optimizer_spec=j_optim.OptimizerSpec(**spec_kw), remat=True,
        compute_dtype=None if compute == "float32" else jnp.bfloat16, ema_decay=ema_decay)
    params_j = prep_j(jax.tree.map(jnp.asarray, base), dtype=jnp.float32)
    state_j = init_j(params_j)

    cfg = TransformerConfig.tiny(dtype={"float32": torch.float32, "bfloat16": torch.bfloat16}[compute])
    prep, init, step = make_full_train_step(
        cfg, optimizer_spec=optim.OptimizerSpec(**spec_kw), remat=True,
        compute_dtype=None if compute == "float32" else torch.bfloat16, ema_decay=ema_decay)
    params = prep(transformer_from_jax(base, TransformerConfig.tiny(), device="cpu"), dtype=torch.float32)
    start = [x.clone() for x in floating_leaves(params)]
    state = init(params)
    batch = _batch(cfg_j)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss_tol, move_tol = TOLS[compute]
    for i in range(steps):
        rng = jax.random.PRNGKey(200 + i)
        ts, noise = _draws(rng, batch["video_latents"].shape)
        params_j, state_j, loss_j = step_j(params_j, state_j, jb, rng)
        params, state, loss = step(params, state, tb, timesteps=ts, noise=noise)
        assert abs(loss.item() - float(loss_j)) <= loss_tol * abs(float(loss_j)), (i, loss.item(), float(loss_j))
    start_j = prep_j(jax.tree.map(jnp.asarray, base), dtype=jnp.float32)
    source = transformer_from_jax(base, TransformerConfig.tiny(), device="cpu")
    # the total movement, and two leaves by name: block 0's fused qkv ([3D, D]
    # in the port, [D, 3D] kernel in JAX) and proj_out (also in the EMA)
    got_norm = np.sqrt(sum(float(((x.detach() - s) ** 2).sum()) for x, s in zip(floating_leaves(params), start)))
    want_norm = float(jnp.sqrt(sum(jnp.sum((a - b) ** 2) for a, b in zip(jax.tree.leaves(params_j),
                                                                        jax.tree.leaves(start_j)))))
    assert want_norm > 0 and abs(got_norm - want_norm) <= move_tol * want_norm

    def moved(tree_t, tree_j):
        qkv = (tree_t["blocks"][0]["attn"]["qkv"]["weight"] - source["blocks"][0]["attn"]["qkv"]["weight"]).numpy()
        qkv_j = np.asarray(tree_j["blocks"]["attn"]["qkv"]["kernel"][0] - start_j["blocks"]["attn"]["qkv"]["kernel"][0]).T
        proj = (tree_t["proj_out"]["weight"] - source["proj_out"]["weight"]).numpy()
        proj_j = np.asarray(tree_j["proj_out"]["kernel"] - start_j["proj_out"]["kernel"]).T
        return (qkv, qkv_j), (proj, proj_j)

    trees = [(params, params_j)] + ([(state[1], state_j[1])] if ema_decay else [])
    for tree_t, tree_j in trees:
        for got, want in moved(tree_t, tree_j):
            assert np.abs(want).max() > 0
            assert np.linalg.norm(got - want) <= move_tol * np.linalg.norm(want)


def test_ema_moves_only_on_the_accumulation_boundary():
    """With accumulation 2 the weights and the EMA stay put on the first
    micro-step and move on the second (JAX folds the boundary into the
    decay); the master copy does not alias the tree it was prepared from."""
    base = perturb(init_transformer_params(jax.random.PRNGKey(0), JTransformerConfig.tiny()), seed=1)
    cfg = TransformerConfig.tiny()
    prep, init, step = make_full_train_step(cfg, optimizer_spec=optim.OptimizerSpec(
        learning_rate=1e-3, gradient_accumulation_steps=2), ema_decay=0.5)
    source = transformer_from_jax(base, cfg, device="cpu")
    params = prep(source, dtype=torch.float32)
    assert params["proj_out"]["weight"].data_ptr() != source["proj_out"]["weight"].data_ptr()
    state = init(params)
    tb = {k: torch.from_numpy(v) for k, v in _batch(JTransformerConfig.tiny()).items()}
    before = [x.clone() for x in floating_leaves(state[1])]
    step(params, state, tb, generator=torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(floating_leaves(state[1]), before))
    assert torch.equal(params["proj_out"]["weight"], source["proj_out"]["weight"])
    step(params, state, tb, generator=torch.Generator().manual_seed(1))
    assert not torch.equal(params["proj_out"]["weight"], source["proj_out"]["weight"])
    assert any(not torch.equal(a, b) for a, b in zip(floating_leaves(state[1]), before))


def test_a_data_or_model_mesh_raises_naming_a9():
    """FSDP and TP need a DeviceMesh (a dict of sizes raises); on a one-rank
    ``dp1,tp1`` mesh the sharded step (FSDP gathers, megatron collectives,
    the global clip norm) runs the sharded code and equals the unsharded
    step bit for bit: every collective of one rank copies."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    cfg = TransformerConfig.tiny()
    for axes in ({"data": 2}, {"model": 4}, {"data": 2, "model": 2}):
        with pytest.raises(ValueError, match="need a DeviceMesh"):
            make_full_train_step(cfg, mesh=axes)
    make_full_train_step(cfg, mesh={"seq": 4})  # a seq mesh is the SP backends', not FSDP
    base = perturb(init_transformer_params(jax.random.PRNGKey(0), JTransformerConfig.tiny()), seed=1)
    tb = {k: torch.from_numpy(v) for k, v in _batch(JTransformerConfig.tiny()).items()}
    spec = optim.OptimizerSpec(learning_rate=1e-3, max_grad_norm=0.5)
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
        results = []
        # contiguous weights, as a checkpoint's are: the shards and the gathered
        # blocks are, and a weight's layout picks its matmul's summation order
        source = jax.tree.map(lambda x: x.contiguous(), transformer_from_jax(base, cfg, device="cpu"))
        for m in (None, mesh):
            prep, init, step = make_full_train_step(cfg, optimizer_spec=spec, mesh=m, ema_decay=0.9)
            params = prep(source, dtype=torch.float32)
            state = init(params)
            losses = []
            for i in range(2):
                ts, noise = _draws(jax.random.PRNGKey(300 + i), tb["video_latents"].shape)
                params, state, loss = step(params, state, tb, timesteps=ts, noise=noise)
                losses.append(loss)
            results.append((losses, floating_leaves(params) + floating_leaves(state[1])))
        assert prep.specs["blocks"][0]["ff"]["net_0"]["weight"].data_dim is not None
        assert all(torch.equal(a, b) for a, b in zip(results[0][0], results[1][0]))
        assert all(torch.equal(a, b) for a, b in zip(results[0][1], results[1][1]))
    finally:
        dist.destroy_process_group()
