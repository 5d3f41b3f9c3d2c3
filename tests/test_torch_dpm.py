"""The port's DPM scheduler against the JAX package's: the host tables of
``dpm_multipliers`` and one ``dpm_step`` on seeded inputs."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from s2v_tpu.config import SchedulerConfig as JSchedulerConfig
from s2v_tpu.schedulers import ddim as j_ddim
from s2v_tpu.schedulers import dpm as j_dpm
from s2v_torch.schedulers import dpm

# both build the tables in float64 and round them to float32: equal to an
# ulp; the step is a few fp32 products of O(1) values
TABLE_ATOL = 1e-6
STEP_ATOL = 1e-6


def _schedule(steps, set_alpha_to_one):
    cfg = JSchedulerConfig(set_alpha_to_one=set_alpha_to_one)
    ac = j_ddim.compute_alphas_cumprod(cfg)
    ts = j_ddim.get_timesteps(cfg, steps)
    return (ac, ts, cfg.num_train_timesteps, steps, set_alpha_to_one)


@pytest.mark.parametrize("set_alpha_to_one", [True, False])
@pytest.mark.parametrize("steps", [1, 2, 3, 50])
def test_dpm_multipliers_match_jax(steps, set_alpha_to_one):
    args = _schedule(steps, set_alpha_to_one)
    got = dpm.dpm_multipliers(*args)
    if steps == 2 and set_alpha_to_one:
        # step 1 follows lamb = -inf and ends at lamb_next = +inf: r = inf / inf
        # on a lane whose has_back is 0.  JAX's finiteness check raises there;
        # the port masks that r to 1 (never read), and the other tables are
        # the first-order update's, computed here in float64.
        with pytest.raises(FloatingPointError):
            j_dpm.dpm_multipliers(*args)
        assert all(np.isfinite(v).all() for v in got.values())
        np.testing.assert_array_equal(got["has_back"], [0.0, 0.0])
        np.testing.assert_array_equal(got["mult3"], [1.5, 1.5])
        np.testing.assert_array_equal(got["mult4"], [0.5, 0.5])
        ac, ts = args[0].astype(np.float64), args[1]
        a_t, a_prev = ac[ts], np.array([ac[ts[1]], 1.0])
        np.testing.assert_allclose(got["a_t"], a_t, atol=TABLE_ATOL, rtol=0)
        # mult1 and mult_noise at step 0 (lamb = -inf) and step 1 (lamb_next = +inf) collapse to 0
        np.testing.assert_array_equal(got["mult1"], [0.0, 0.0])
        np.testing.assert_allclose(got["mult2"], -np.sqrt(a_prev), atol=TABLE_ATOL, rtol=0)
        np.testing.assert_allclose(got["mult_noise"], [np.sqrt(1.0 - a_prev[0]), 0.0], atol=TABLE_ATOL, rtol=0)
        return
    want = j_dpm.dpm_multipliers(*args)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == np.float32 and got[k].shape == (steps,), k
        np.testing.assert_allclose(got[k], want[k], atol=TABLE_ATOL, rtol=0, err_msg=k)
    assert got["has_back"][0] == 0.0  # step 0 has no previous x0


@pytest.mark.parametrize("prediction_type", ["v_prediction", "epsilon", "sample"])
@pytest.mark.parametrize("i", [0, 1, 2])
def test_dpm_step_matches_jax(prediction_type, i):
    tables = j_dpm.dpm_multipliers(*_schedule(3, True))
    mults = {k: v[i] for k, v in tables.items()}
    rng = np.random.RandomState(10 + i)
    mo, x, old, n1, n2 = (rng.randn(2, 3, 4, 4, 4).astype(np.float32) for _ in range(5))
    want = j_dpm.dpm_step(*(jnp.asarray(a) for a in (mo, x, old, n1)), mults, prediction_type,
                          noise2=jnp.asarray(n2))
    got = dpm.dpm_step(*(torch.from_numpy(a) for a in (mo, x, old, n1)), mults, prediction_type,
                       noise2=torch.from_numpy(n2))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=STEP_ATOL, rtol=0)


def test_dpm_step_keeps_the_sample_dtype_and_rejects_unknown_types():
    tables = dpm.dpm_multipliers(*_schedule(3, True))
    mults = {k: v[1] for k, v in tables.items()}
    x = torch.randn(1, 2, 2, 2, 4, dtype=torch.bfloat16)
    prev, x0 = dpm.dpm_step(torch.randn(x.shape), x, torch.zeros_like(x), torch.randn(x.shape), mults)
    assert prev.dtype == x0.dtype == torch.bfloat16
    with pytest.raises(ValueError):
        dpm.dpm_step(x, x, x, x, mults, "flow")
