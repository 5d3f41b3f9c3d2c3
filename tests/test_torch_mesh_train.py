"""Training on ``data`` and ``model`` mesh dims over gloo ranks
(``tests/_torch_mesh_worker.py``), against the JAX package under the same
mesh on virtual CPU devices, on the tiny DiT, two steps each with JAX's
draws (its rng's timesteps and noise, handed to the port's hooks):

* the LoRA step (``training/lora.py``) at ``dp2`` (the batch split), ``tp2``
  (the base sliced, the adapters' deltas sliced as their kernels) and with
  the base sharded over ``dp2`` (``--fsdp_base``: bf16-layout fp32 and
  QLoRA int8), against JAX's ``make_lora_train_step``;
* full fine-tuning (``training/full.py``: FSDP, and megatron TP at
  ``dp2,tp2``) with adamw, a clip norm that clips and an epsilon that keeps
  the clip factor visible through Adam, and with prodigy, whose d-estimate
  sums over every shard (at a learning-rate factor of 100, see ``PRODIGY``);
  the EMA too;
* the sharded train state's round trip, and its refusal of another mesh;
* the trainer CLI under ``torchrun --nproc_per_node 2 --mesh dp2``: its
  adapters equal one process's run of the same batch, and a resumed run
  the uninterrupted one, bit for bit.

Tolerances: fp32; losses to 1e-4 of their magnitude; the params' (or
adapters') movement over the two steps to 1e-3 relative L2, as the
single-card full-train test (Adam divides by sqrt(nu), magnifying the
reduction order of near-zero gradients), 1e-2 for QLoRA (int8 products).
FSDP shards leaves of 2^10 elements and more here (JAX's
``fsdp_min_size``), so that the tiny model has sharded and whole leaves.
"""

import functools
import os
import subprocess
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from _torch_mesh_worker import run_mesh_ranks
from _torch_parity import perturb, rand
from s2v_tpu.config import TransformerConfig as JTransformerConfig
from s2v_tpu.models.transformer import init_transformer_params
from s2v_tpu.ops.quant import quantize_transformer_params as j_quantize
from s2v_tpu.ops.rope import build_segmented_rope, get_3d_rotary_pos_embed
from s2v_tpu.parallel import default_logical_map as j_logical_map
from s2v_tpu.parallel import mesh_context as j_mesh_context
from s2v_tpu.parallel.sharding import make_mesh, parse_mesh_spec, shard_params, transformer_param_specs_like
from s2v_tpu.training import full as j_full
from s2v_tpu.training import lora as j_lora
from s2v_tpu.training import optim as j_optim
from test_torch_full_train import ALPHAS
from test_torch_train_cli import _argv, tiny  # noqa: F401  (the module's fixture)

LOSS_REL, MOVE_REL, QLORA_MOVE_REL = 1e-4, 1e-3, 1e-2
MIN_SIZE = 2 ** 10
RANK, ALPHA = 4, 8.0
ADAMW = dict(learning_rate=1e-3, max_grad_norm=0.1, epsilon=1e-4)
# prodigy's d starts at 1e-6: a learning-rate factor of 100 moves the weights
# well past fp32 rounding in two steps, and the second step's size is the
# d-estimate the first step's global sums made
PRODIGY = dict(optimizer="prodigy", learning_rate=100.0)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_mesh(spec):
    sizes = parse_mesh_spec(spec)
    mesh = make_mesh(sizes, jax.devices()[:int(np.prod(list(sizes.values())))])
    return mesh, j_mesh_context(mesh, j_logical_map(mesh))


@functools.lru_cache(maxsize=None)
def _setup():
    cfg_j = JTransformerConfig.tiny()
    base = perturb(init_transformer_params(jax.random.PRNGKey(0), cfg_j), seed=1)
    b, f, h, w, c = 2, 3, 8, 8, cfg_j.in_channels
    batch = {"video_latents": rand(b, f, h, w, c, seed=2), "ref_latents": rand(b, 1, h, w, c, seed=3),
             "text_embeds": rand(b, cfg_j.max_text_seq_length, cfg_j.text_embed_dim, seed=4)}
    cos, sin = get_3d_rotary_pos_embed(cfg_j.attention_head_dim, ((0, 0), (4, 4)), (4, 4), f + 1)
    cs, sn = build_segmented_rope(cfg_j.max_text_seq_length, cos[:16], sin[:16], cos[16:], sin[16:])
    batch["rope_cos"], batch["rope_sin"] = np.asarray(cs), np.asarray(sn)
    spec = j_lora.LoRASpec(rank=RANK, alpha=ALPHA)
    tree = jax.tree.map(np.asarray, j_lora.init_lora_params(jax.random.PRNGKey(3), base, spec))
    rng = np.random.RandomState(3)
    for ab in tree.values():  # nonzero b, so that a's gradients are nonzero too
        ab["b"] = (ab["b"] + 0.1 * rng.randn(*ab["b"].shape)).astype(np.float32)
    rngs = [jax.random.PRNGKey(400 + i) for i in range(2)]
    draws = []
    for r in rngs:
        k_t, k_n = jax.random.split(r)
        draws.append((np.asarray(jax.random.randint(k_t, (b,), 0, ALPHAS.shape[0])),
                      np.asarray(jax.random.normal(k_n, batch["video_latents"].shape, jnp.float32))))
    return cfg_j, base, batch, spec, tree, rngs, draws


def _jax_batch(mesh, batch):
    out = {k: jnp.asarray(v) for k, v in batch.items()}
    if "data" in mesh.axis_names:
        for k in ("video_latents", "ref_latents", "text_embeds"):
            out[k] = jax.device_put(out[k], NamedSharding(mesh, P("data")))
    return out


@functools.lru_cache(maxsize=None)
def _jax_lora(spec_str, fsdp_base=False, quantize=False):
    cfg_j, base, batch, spec, tree, rngs, _ = _setup()
    mesh, ctx = _jax_mesh(spec_str)
    base_j = jax.tree.map(jnp.asarray, base)
    if quantize:
        base_j = j_quantize(base_j)
    if fsdp_base:
        specs = j_full.fsdp_param_specs(base_j, 2, min_size=MIN_SIZE)
        base_j = jax.tree.map(lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), base_j, specs)
    elif "model" in mesh.axis_names:
        base_j = shard_params(base_j, mesh, transformer_param_specs_like(base_j))
    init, step = j_lora.make_lora_train_step(base_j, cfg_j, spec, attention_backend="xla", remat=True,
                                             optimizer_spec=j_optim.OptimizerSpec(**ADAMW))
    lora = jax.tree.map(jnp.asarray, tree)
    state = init(lora)
    losses = []
    with ctx:
        for r in rngs:
            lora, state, loss = step(lora, state, _jax_batch(mesh, batch), r)
            losses.append(float(loss))
    return losses, jax.tree.map(np.asarray, lora), (jax.tree.map(np.asarray, base_j) if quantize else base)


@functools.lru_cache(maxsize=None)
def _jax_full(spec_str, opt):
    cfg_j, base, batch, _, _, rngs, _ = _setup()
    mesh, ctx = _jax_mesh(spec_str)
    prep, init, step = j_full.make_full_train_step(cfg_j, optimizer_spec=j_optim.OptimizerSpec(**dict(opt)),
                                                   attention_backend="xla", remat=True, mesh=mesh,
                                                   fsdp_min_size=MIN_SIZE, ema_decay=0.9)
    params = prep(jax.tree.map(jnp.asarray, base), dtype=jnp.float32)
    state = init(params)
    losses = []
    with ctx:
        for r in rngs:
            params, state, loss = step(params, state, _jax_batch(mesh, batch), r)
            losses.append(float(loss))
    return losses, jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, state[1])


LORA_CASES = {"dp2": ("dp2", False, False), "tp2": ("tp2", False, False), "fsdp_base": ("dp2", True, False),
              "fsdp_base_qlora": ("dp2", True, True)}
FULL_CASES = {"dp2_adamw": ("dp2", ADAMW), "dp2_prodigy": ("dp2", PRODIGY), "dp2_tp2_adamw": ("dp2,tp2", ADAMW),
              "dp2_tp2_prodigy": ("dp2,tp2", PRODIGY)}


@functools.lru_cache(maxsize=None)
def _run(world):
    _, base, batch, _, tree, _, draws = _setup()
    cases = {}
    if world == 2:
        for name, (spec, fsdp, quant) in LORA_CASES.items():
            base_in = _jax_lora(spec, fsdp, quant)[2]
            cases[f"lora_{name}"] = ("lora", spec, dict(base=base_in, tree=tree, batch=batch, draws=draws, rank=RANK,
                                                         alpha=ALPHA, opt_kw=ADAMW, fsdp_base=fsdp, min_size=MIN_SIZE))
        out = tempfile.mkdtemp(prefix="mesh_state_")
        cases["state"] = ("state", "dp2", dict(base=base, out_dir=out, other="tp2"))
    for name, (spec, opt) in FULL_CASES.items():
        if (world == 2) == ("tp" not in spec):
            cases[f"full_{name}"] = ("full", spec, dict(base=base, batch=batch, draws=draws, opt_kw=opt,
                                                        ema_decay=0.9, min_size=MIN_SIZE))
    return run_mesh_ranks(world, cases, tempfile.mkdtemp(prefix=f"mesh_train{world}_"), timeout_s=240)


def _moved_close(got, start, want, want_start, rel):
    g = np.concatenate([(a - b).ravel() for a, b in zip(got, start)])
    w = np.concatenate([(a - b).ravel() for a, b in zip(want, want_start)])
    assert np.linalg.norm(w) > 0
    assert np.linalg.norm(g - w) <= rel * np.linalg.norm(w), np.linalg.norm(g - w) / np.linalg.norm(w)


@pytest.mark.parametrize("name", list(LORA_CASES))
def test_lora_step_matches_jax_on_the_mesh(name):
    spec, fsdp, quant = LORA_CASES[name]
    losses_j, lora_j, _ = _jax_lora(spec, fsdp, quant)
    tree = _setup()[4]
    for rank, res in enumerate(_run(2)):
        got = res[f"lora_{name}"]
        np.testing.assert_allclose(got["losses"], losses_j, rtol=LOSS_REL, err_msg=f"rank {rank}")
        if fsdp:
            assert got["sharded_leaves"] > 0
        keys = [(n, k) for n in sorted(tree) for k in ("a", "b")]
        _moved_close([got["lora"][n][k] for n, k in keys], [tree[n][k] for n, k in keys],
                     [lora_j[n][k] for n, k in keys], [tree[n][k] for n, k in keys],
                     QLORA_MOVE_REL if quant else MOVE_REL)


def _jax_leaves(tree):
    """JAX's params as the port's floating leaves, in their order (stacked
    blocks unstacked, q/k/v fused, kernels transposed)."""
    from s2v_torch.config import TransformerConfig
    from s2v_torch.loaders.jax_params import transformer_from_jax
    from s2v_torch.training.full import floating_leaves

    return [x.numpy() for x in floating_leaves(transformer_from_jax(tree, TransformerConfig.tiny(), device="cpu"))]


@pytest.mark.parametrize("name", list(FULL_CASES))
def test_full_step_matches_jax_on_the_mesh(name):
    spec, opt = FULL_CASES[name]
    losses_j, params_j, ema_j = _jax_full(spec, tuple(sorted(opt.items())))
    start = _jax_leaves(_setup()[1])
    for rank, res in enumerate(_run(4 if "tp" in spec else 2)):
        got = res[f"full_{name}"]
        np.testing.assert_allclose(got["losses"], losses_j, rtol=LOSS_REL, err_msg=f"rank {rank}")
        _moved_close(got["params"], start, _jax_leaves(params_j), start, MOVE_REL)
        _moved_close(got["ema"], start, _jax_leaves(ema_j), start, MOVE_REL)


def test_full_step_ranks_agree():
    """Every rank ends with the same whole params: the clip factor and the
    d-estimate are global, so no rank steps differently."""
    for world in (2, 4):
        results = _run(world)
        for name in results[0]:
            if name.startswith("full_"):
                for res in results[1:]:
                    assert all(np.array_equal(a, b) for a, b in zip(res[name]["params"], results[0][name]["params"]))


def test_sharded_train_state_round_trip_and_refusal():
    for rank, res in enumerate(_run(2)):
        got = res["state"]
        assert got["equal"], rank
        assert got["files"] == ["tensors.rank0-of-2.safetensors", "tensors.rank1-of-2.safetensors", "tree.json"]
        assert "written on mesh data2, this run is on mesh model2" in got["errors"]["other"]
        assert "this run is on mesh one card (no mesh)" in got["errors"]["none"]


def _torchrun_train(args, timeout=240):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
                           "-m", "s2v_torch.train", *args], env=env, cwd=REPO, capture_output=True, text=True,
                          timeout=timeout)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc


def test_trainer_cli_mesh_dp2_and_its_resume(tiny, tmp_path):  # noqa: F811
    """``--mesh dp2 --train_batch_size 2``: rank 0 alone writes the adapters,
    equal to one process's run of the same batches; each rank writes its
    shard file of every state; a resumed run equals the uninterrupted one."""
    from s2v_torch import train
    from s2v_torch.loaders.safetensors_io import load_safetensors

    flags = ["--train_batch_size", "2", "--max_train_steps", "2", "--checkpointing_steps", "1",
             "--learning_rate", "1e-2"]
    _torchrun_train(_argv(tiny, tmp_path / "mesh", *flags, "--mesh", "dp2"))
    assert sorted(os.listdir(tmp_path / "mesh" / "train_state_1")) == [
        "tensors.rank0-of-2.safetensors", "tensors.rank1-of-2.safetensors", "tree.json"]
    train.main(train.get_args(_argv(tiny, tmp_path / "one", *flags)))
    lora_file = "pytorch_lora_weights_transformer.safetensors"
    got, want = (load_safetensors(str(tmp_path / d / lora_file)) for d in ("mesh", "one"))
    assert sorted(got) == sorted(want)
    for k in want:  # B starts at 0: its whole value is the two steps' movement
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert np.linalg.norm(g - w) <= MOVE_REL * np.linalg.norm(w), k
    _torchrun_train(_argv(tiny, tmp_path / "resumed", *flags, "--mesh", "dp2", "--resume_from_checkpoint",
                          str(tmp_path / "mesh" / "train_state_1")))
    resumed = load_safetensors(str(tmp_path / "resumed" / lora_file))
    assert all(torch.equal(torch.as_tensor(resumed[k]), torch.as_tensor(got[k])) for k in got)
    with pytest.raises(SystemExit, match="written on mesh data2, this run is on mesh one card"):
        train.main(train.get_args(_argv(tiny, tmp_path / "refused", *flags, "--resume_from_checkpoint",
                                        str(tmp_path / "mesh" / "train_state_1"))))
