"""The tiny DiT and T5 on ``data`` and ``model`` mesh dims over gloo ranks
(``tests/_torch_mesh_worker.py``), against the JAX package under the same
mesh on virtual CPU devices (GSPMD, ``s2v_tpu/parallel/sharding.py``).

* The forward at ``tp2`` and ``dp2`` (2 ranks) and ``dp2,tp2`` and
  ``sp2,tp2`` (4 ranks): the gathered output on every rank, and what each
  rank held before a gather: its rows of the batch (``data``) and its
  frames (``seq``).
* Block 0's attention on each rank's heads at ``tp2`` and ``dp2,tp2``,
  against the same heads of JAX's (the fused qkv is sliced per head; a
  contiguous slice would give other heads and no error).
* T5's encode at ``tp2``.

Tolerances: fp32 throughout; the forward within 1e-4 of JAX (as the
sequence-parallel tests), the heads within 1e-5 (one projection and one
attention), T5 within 1e-4 of its output's scale.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from _torch_mesh_worker import run_mesh_ranks
from _torch_parity import perturb, rand
from s2v_tpu.config import T5Config as JT5Config
from s2v_tpu.config import TransformerConfig as JTransformerConfig
from s2v_tpu.models.t5 import init_t5_params
from s2v_tpu.models.t5 import t5_encode as j_t5_encode
from s2v_tpu.models.transformer import init_transformer_params
from s2v_tpu.models.transformer import transformer_forward as j_forward
from s2v_tpu.ops.attention import joint_attention as j_joint_attention
from s2v_tpu.ops.rope import build_segmented_rope, get_3d_rotary_pos_embed
from s2v_tpu.parallel import default_logical_map as j_logical_map
from s2v_tpu.parallel import mesh_context as j_mesh_context
from s2v_tpu.parallel.sharding import make_mesh, parse_mesh_spec, shard_params, t5_param_specs
from s2v_tpu.parallel.sharding import transformer_param_specs_like

ATOL, RTOL = 1e-4, 1e-4
HEADS_ATOL = 1e-5
T5_REL = 1e-4
FRAMES = 3
TWO = ("tp2", "dp2")
FOUR = ("dp2,tp2", "sp2,tp2")


def _jax_mesh(spec):
    sizes = parse_mesh_spec(spec)
    mesh = make_mesh(sizes, jax.devices()[:int(np.prod(list(sizes.values())))])
    return mesh, j_mesh_context(mesh, j_logical_map(mesh))


@functools.lru_cache(maxsize=None)
def _inputs():
    cfg_j = JTransformerConfig.tiny()
    params = perturb(init_transformer_params(jax.random.PRNGKey(0), cfg_j), seed=1)
    b, f, h, w, c = 2, FRAMES, 8, 8, cfg_j.in_channels
    video, ref = rand(b, f, h, w, c, seed=2), rand(b, 1, h, w, c, seed=3)
    text = rand(b, cfg_j.max_text_seq_length, cfg_j.text_embed_dim, seed=4)
    ts = np.array([999, 500], np.int32)
    gh, gw = h // 2, w // 2
    cos, sin = get_3d_rotary_pos_embed(cfg_j.attention_head_dim, ((0, 0), (gh, gw)), (gh, gw), f + 1)
    tok = gh * gw
    cs, sn = (np.asarray(x) for x in build_segmented_rope(cfg_j.max_text_seq_length, cos[:tok], sin[:tok],
                                                          cos[tok:], sin[tok:]))
    return cfg_j, params, (video, ref, text, ts, cs, sn)


@functools.lru_cache(maxsize=None)
def _jax_forward(spec):
    """JAX's forward with its params placed by the TP specs and its batch on
    ``data``, under the mesh's context."""
    cfg_j, params, inputs = _inputs()
    mesh, ctx = _jax_mesh(spec)
    tree = jax.tree.map(jnp.asarray, params)
    if "model" in mesh.axis_names:
        tree = shard_params(tree, mesh, transformer_param_specs_like(tree))
    video, ref, text, ts, cs, sn = (jnp.asarray(x) for x in inputs)
    if "data" in mesh.axis_names:
        video, ref, text, ts = (jax.device_put(x, NamedSharding(mesh, P("data"))) for x in (video, ref, text, ts))
    backend = "sp_allgather" if "seq" in mesh.axis_names else "xla"
    with ctx:
        return np.asarray(j_forward(tree, cfg_j, video, ref, text, ts, cs, sn, attention_backend=backend))


def _heads_x():
    cfg_j = JTransformerConfig.tiny()
    return rand(2, 20, cfg_j.inner_dim, seed=9)


@functools.lru_cache(maxsize=None)
def _jax_heads():
    """Block 0's attention of every head, ``[B, S, H, d]``: its ``to_out``
    made the identity, so JAX's output is the heads' concatenation."""
    cfg_j, params, _ = _inputs()
    attn = jax.tree.map(lambda a: jnp.asarray(a[0]), params["blocks"]["attn"])
    d = cfg_j.inner_dim
    attn["to_out"] = {"kernel": jnp.eye(d, dtype=jnp.float32), "bias": jnp.zeros(d, jnp.float32)}
    out = np.asarray(j_joint_attention(attn, jnp.asarray(_heads_x()), cfg_j.num_attention_heads, backend="xla"))
    return out.reshape(*out.shape[:2], cfg_j.num_attention_heads, -1)


@functools.lru_cache(maxsize=None)
def _t5_case():
    cfg_j = JT5Config.tiny(d_model=32)
    params = perturb(init_t5_params(jax.random.PRNGKey(2), cfg_j), seed=3, scale=0.05)
    ids = np.random.RandomState(5).randint(0, cfg_j.vocab_size, (2, 12)).astype(np.int32)
    mesh, ctx = _jax_mesh("tp2")
    tree = shard_params(jax.tree.map(jnp.asarray, params), mesh, t5_param_specs(params))
    with ctx:
        want = np.asarray(jax.jit(lambda p, i: j_t5_encode(p, cfg_j, i))(tree, jnp.asarray(ids)))
    return params, ids, want


@functools.lru_cache(maxsize=None)
def _run(world):
    import tempfile

    _, params, inputs = _inputs()
    cases = {f"forward_{spec}": ("forward", spec, dict(params=params, inputs=inputs,
                                                       backend="sp_allgather" if "sp" in spec else "plain"))
             for spec in (TWO if world == 2 else FOUR)}
    cases["heads"] = ("heads", "tp2" if world == 2 else "dp2,tp2", dict(params=params, x=_heads_x()))
    if world == 2:
        t5_params, ids, _ = _t5_case()
        cases["t5"] = ("t5", "tp2", dict(params=t5_params, ids=ids))
    return run_mesh_ranks(world, cases, tempfile.mkdtemp(prefix=f"mesh_model{world}_"), timeout_s=180)


@pytest.mark.parametrize("spec", TWO + FOUR)
def test_forward_matches_jax_on_the_mesh(spec):
    want = _jax_forward(spec)
    for rank, res in enumerate(_run(2 if spec in TWO else 4)):
        np.testing.assert_allclose(res[f"forward_{spec}"]["out"], want, atol=ATOL, rtol=RTOL,
                                   err_msg=f"rank {rank} {spec}")


@pytest.mark.parametrize("spec", ("dp2", "dp2,tp2"))
def test_each_data_rank_holds_its_rows_before_the_gather(spec):
    """The rows a rank ran, before the output's all-gather, are its rows of
    JAX's output: rank r of ``data`` the batch rows [r·B/2, (r+1)·B/2)."""
    want = _jax_forward(spec)
    for rank, res in enumerate(_run(2 if spec in TWO else 4)):
        got = res[f"forward_{spec}"]
        r, n = got["coords"]["data"]
        rows = want.shape[0] // n
        assert got["rows"].shape[0] == rows
        np.testing.assert_allclose(got["rows"], want[r * rows:(r + 1) * rows], atol=ATOL, rtol=RTOL,
                                   err_msg=f"rank {rank} {spec}")


def test_each_seq_rank_holds_its_frames_before_the_gather():
    """At ``sp2,tp2`` each rank's frames (3 latent frames on 2 ranks: 2 and
    1 real, one dummy) are JAX's frames, before the video rows' gather."""
    want = _jax_forward("sp2,tp2")
    for rank, res in enumerate(_run(4)):
        got = res["forward_sp2,tp2"]
        first, real = got["first_frame"], got["real_frames"]
        assert real >= 1
        np.testing.assert_allclose(got["frames"][:, :real], want[:, first:first + real], atol=ATOL, rtol=RTOL,
                                   err_msg=f"rank {rank}")


@pytest.mark.parametrize("world", (2, 4))
def test_each_model_rank_computes_its_heads(world):
    want = _jax_heads()
    for rank, res in enumerate(_run(world)):
        got = res["heads"]
        r, n = got["coords"]["model"]
        h = want.shape[2] // n
        assert got["heads"].shape[2] == h
        np.testing.assert_allclose(got["heads"], want[:, :, r * h:(r + 1) * h], atol=HEADS_ATOL,
                                   err_msg=f"rank {rank} model rank {r}")


def test_t5_encode_matches_jax_at_tp2():
    _, _, want = _t5_case()
    for rank, res in enumerate(_run(2)):
        got = res["t5"]
        assert got["local_q_rows"] * 2 == JT5Config.tiny(d_model=32).num_heads * JT5Config.tiny().d_kv
        assert np.abs(got["out"] - want).max() <= T5_REL * np.abs(want).max(), rank
