"""The port's exact sequence-parallel backends (``sp_allgather``,
``sp_ulysses``, ``ring``) and ``sp_int8``
(``s2v_torch/parallel/sp_attention.py``, ``ring_attention.py``; kernels
B1/B2/B3 through their plain versions) on the frame shards of real gloo
process groups of 1, 2 and 4 ranks, against the JAX package's wrappers under
``shard_map`` on virtual CPU devices: ``allgather_kv_attention``,
``ulysses_attention``, ``ring_attention`` (its Pallas hop kernel in
interpret mode, with lse) and their ``jax.grad``; ``sp_int8`` against JAX's
AG-KV wrapper around the int8 kernel (interpret mode) on a ring of the same
size.  Each rank takes its rows of whole inputs (``tests/_torch_sp_worker.py``),
the frames sharded with ring padding: 13 frames leave rank 3 of 4 one real
frame and three dummy frames.  Each spawn runs all its cases at once and has
its own time limit."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_parity import band_inputs
from _torch_sp_worker import assert_grads_match, assert_rows_match, global_rows_spread, run_ranks
from s2v_tpu.ops.attention import _int8_attention_inference_only
from s2v_tpu.parallel.ring_attention import ring_attention as j_ring
from s2v_tpu.parallel.ring_attention import ring_attention_trainable as j_ring_trainable
from s2v_tpu.parallel.sharding import make_mesh
from s2v_tpu.parallel.sp_attention import allgather_kv_attention as j_allgather
from s2v_tpu.parallel.sp_attention import ulysses_attention as j_ulysses

# test_torch_sp_attention.py's tolerances (the JAX package's, tests/test_parallel.py:540-690)
FWD_ATOL, FWD_RTOL = 2e-5, 1e-4
GRAD_ATOL, GRAD_RTOL = 2e-4, 1e-3
LSE_ATOL = 1e-5
# sp_int8 against JAX's on a ring of the same size: each rank quantizes its
# own q rows with one scale, and the port's rows ([text | ref | its frames])
# are not JAX's (a ring-padded row shard), so above one rank the roundings
# differ (ROADMAP C.27); at one rank both take the whole q.  Measured on
# these inputs: 7.5e-8 at one rank, 6.7e-4 at two, 8.6e-4 at four; the limit
# above one rank is about twice that (the exact backends' own is FWD_ATOL).
INT8_ATOL = {1: FWD_ATOL, 2: 2e-3, 4: 2e-3}
BAND = (5, 4, 0)  # global_len, tokens_per_frame (window unused)
HEADS = 4  # Ulysses at 4 ranks needs heads % 4 == 0
FRAMES = (13, 8)
EXACT = ("sp_allgather", "sp_ulysses", "ring")
WORLD_SIZES = (1, 2, 4)


def _inputs(n_frames):
    g, tpf, _ = BAND
    return band_inputs(1, HEADS, g, tpf, n_frames, seed=200 + n_frames, d=8)


def _mesh(ring):
    return make_mesh({"seq": ring}, jax.devices()[:ring])


@functools.lru_cache(maxsize=None)
def _jax_exact(backend, n_frames):
    """JAX's forward (and lse for ring) and grads of sum(o * ct) on 4 devices."""
    mesh = _mesh(4)
    q, k, v, ct = (jnp.asarray(x) for x in _inputs(n_frames))
    if backend == "ring":
        o, lse = j_ring(q, k, v, mesh, "seq", use_kernel=True, interpret=True, return_lse=True)

        def fn(q_, k_, v_):
            return j_ring_trainable(q_, k_, v_, mesh, "seq", None, True, True)
    else:
        wrapper = j_allgather if backend == "sp_allgather" else j_ulysses
        fn = functools.partial(wrapper, mesh=mesh, axis_name="seq")
        o, lse = fn(q, k, v), None
    grads = jax.grad(lambda *a: jnp.sum(fn(*a) * ct), argnums=(0, 1, 2))(q, k, v)
    return np.asarray(o), None if lse is None else np.asarray(lse), [np.asarray(x) for x in grads]


@functools.lru_cache(maxsize=None)
def _jax_int8(n_frames, ring):
    """JAX's sp_int8 (AG-KV around the int8 kernel in interpret mode) on a ring of ``ring`` devices."""
    q, k, v, _ = (jnp.asarray(x) for x in _inputs(n_frames))

    def attn(q_, k_, v_, scale):
        return _int8_attention_inference_only(q_, k_, v_, scale, True)

    return np.asarray(j_allgather(q, k, v, _mesh(ring), "seq", attn_fn=attn))


def _cases():
    cases = {}
    for f in FRAMES:
        q, k, v, ct = _inputs(f)
        for backend in EXACT + ("sp_int8",):
            cases[f"{backend}_F{f}"] = ("attention", dict(q=q, k=k, v=v, ct=ct, band=BAND, backend=backend))
    return cases


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Each world size's spawn, run once on first use: a list of the ranks' results."""
    runs = {}

    def get(world_size):
        if world_size not in runs:
            runs[world_size] = run_ranks(world_size, _cases(), tmp_path_factory.mktemp(f"spb_ws{world_size}"),
                                         timeout_s=120)
        return runs[world_size]

    return get


@pytest.mark.parametrize("world_size", WORLD_SIZES)
@pytest.mark.parametrize("n_frames", FRAMES)
@pytest.mark.parametrize("backend", EXACT)
def test_forward_matches_jax(ranks, backend, world_size, n_frames):
    """Each rank's own rows (text, ref and its real frames) against the same rows of JAX's output."""
    want, _, _ = _jax_exact(backend, n_frames)
    assert_rows_match(ranks(world_size), f"{backend}_F{n_frames}", want, ("o_inference", "o"), FWD_ATOL, FWD_RTOL)


@pytest.mark.parametrize("world_size", WORLD_SIZES)
@pytest.mark.parametrize("n_frames", FRAMES)
@pytest.mark.parametrize("backend", EXACT)
def test_grads_match_jax(ranks, backend, world_size, n_frames):
    """dq, dk, dv of sum(o * ct): each rank's video rows as its backward
    leaves them, and the ranks' shares of the global rows summed."""
    _, _, want = _jax_exact(backend, n_frames)
    assert_grads_match(ranks(world_size), f"{backend}_F{n_frames}", want, GRAD_ATOL, GRAD_RTOL)


@pytest.mark.parametrize("world_size", WORLD_SIZES)
@pytest.mark.parametrize("n_frames", FRAMES)
def test_ring_lse_matches_jax(ranks, world_size, n_frames):
    """Each rank's own rows of the merged lse of the hops (a hop of dummy frames only is skipped)."""
    _, want, _ = _jax_exact("ring", n_frames)
    results = ranks(world_size)
    for res in results:
        assert np.isfinite(res[f"ring_F{n_frames}"]["lse"]).all()
    assert_rows_match(results, f"ring_F{n_frames}", want, ("lse",), LSE_ATOL, FWD_RTOL, dim=2)


@pytest.mark.parametrize("world_size", WORLD_SIZES)
@pytest.mark.parametrize("n_frames", FRAMES)
def test_sp_int8_matches_jax_within_its_tolerance(ranks, world_size, n_frames):
    want = _jax_int8(n_frames, world_size)
    assert_rows_match(ranks(world_size), f"sp_int8_F{n_frames}", want, ("o_inference", "o"), INT8_ATOL[world_size],
                      0)


@pytest.mark.parametrize("world_size", WORLD_SIZES)
def test_sp_int8_backward_raises_jax_message(ranks, world_size):
    for res in ranks(world_size):
        for f in FRAMES:
            assert "inference-only (no backward kernels)" in res[f"sp_int8_F{f}"]["backward_error"]


@pytest.mark.parametrize("world_size", [2, 4])
def test_ranks_hold_the_same_result(ranks, world_size):
    """Every rank computes the replicated text and ref rows of the output
    (and of ring's lse) itself; here they are held against rank 0's.
    ``sp_ulysses`` gathers them over heads: bit for bit.  The others agree
    to rounding, since each rank's work depends on its own rows:
    ``sp_allgather`` offsets the logits by a bound over the rank's q (B1's
    bounded mode; 8.9e-8 measured here), ``ring`` merges its hops from the
    rank's own keys (2.4e-7 to 4.8e-7), and ``sp_int8`` scales the rank's q
    (8.8e-4, ROADMAP C.27)."""
    results = ranks(world_size)
    limit = {"sp_ulysses": 0.0, "sp_allgather": FWD_ATOL, "ring": FWD_ATOL, "sp_int8": INT8_ATOL[world_size]}
    for case in results[0]:
        assert global_rows_spread(results, case) <= limit[case.rsplit("_F", 1)[0]], case
