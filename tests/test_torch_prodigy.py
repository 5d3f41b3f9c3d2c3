"""The port's prodigy (``s2v_torch/training/optim.py``) against the JAX
package's, ``optax.contrib.prodigy`` as ``s2v_tpu/training/optim.py``
builds it (the schedule as a multiplicative factor, betas, eps, weight
decay; the clip before it and ``optax.MultiSteps`` around it).

Both run 5 optimizer updates from the same fp32 parameters on the same
numpy gradients.  Tolerance: the d-estimate is a ratio of sums over every
element, which the two take in other orders in fp32: 1e-5 relative; the
parameters' total movement from their start agrees to 1e-4 relative L2
(Adam's division by sqrt(nu) magnifies rounding of near-zero entries)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from s2v_tpu.training import optim as j_optim
from s2v_torch.training import optim

SHAPES = [(6, 5), (4,), (3, 2, 7)]
STEPS = 5
ESTIM_RTOL = 1e-5
MOVE_REL_L2 = 1e-4

CASES = {
    "constant": dict(),
    "cosine": dict(lr_scheduler="cosine", max_train_steps=8),
    "clip": dict(max_grad_norm=0.5),
    "linear_clip_accumulate_2": dict(lr_scheduler="linear", max_train_steps=6, max_grad_norm=1.0,
                                     gradient_accumulation_steps=2),
}


def _grads(params, step, micro=0):
    """The gradient of 0.5·|p - target|² at the JAX side's params, plus
    seeded noise: correlated with the path, so the d-estimate grows."""
    rng = np.random.RandomState(100 * step + micro + 1)
    target = np.random.RandomState(7)
    return [(np.asarray(p) - 3.0 * target.randn(*p.shape) + 0.1 * rng.randn(*p.shape)).astype(np.float32)
            for p in params]


@pytest.mark.parametrize("name", list(CASES))
def test_prodigy_matches_optax(name):
    kw = dict(optimizer="prodigy", learning_rate=1.0, beta1=0.9, beta2=0.99, weight_decay=1e-2, **CASES[name])
    rng = np.random.RandomState(0)
    start = [rng.randn(*s).astype(np.float32) for s in SHAPES]
    tx = j_optim.make_optimizer(j_optim.OptimizerSpec(**kw))
    params_j = [jnp.asarray(x) for x in start]
    state_j = tx.init(params_j)
    opt = optim.make_optimizer(optim.OptimizerSpec(**kw))
    params = [torch.from_numpy(x.copy()) for x in start]
    state = opt.init(params)
    k = kw.get("gradient_accumulation_steps", 1)
    for step in range(STEPS):
        for micro in range(k):
            g = _grads(params_j, step, micro)
            updates, state_j = tx.update([jnp.asarray(x) for x in g], state_j, params_j)
            params_j = jax.tree.map(lambda p, u: p + u, params_j, updates)
            opt.step(params, [torch.from_numpy(x) for x in g], state)
        inner = state_j.inner_opt_state if k > 1 else state_j
        prodigy_j = inner[-1] if kw.get("max_grad_norm") else inner
        assert state["count"] == int(prodigy_j.count) == step + 1
        np.testing.assert_allclose(state["estim_lr"].item(), float(prodigy_j.estim_lr), rtol=ESTIM_RTOL)
        np.testing.assert_allclose(state["numerator_weighted"].item(), float(prodigy_j.numerator_weighted),
                                   rtol=ESTIM_RTOL)
        for p, pj, p0 in zip(params, params_j, start):
            want = np.asarray(pj) - p0
            got = p.numpy() - p0
            assert np.linalg.norm(got - want) <= MOVE_REL_L2 * np.linalg.norm(want), (step, name)
    # the d-estimate grew from its 1e-6 start: the adaptive part ran
    assert state["estim_lr"].item() > 1.01 * optim.PRODIGY_ESTIM_LR0


def test_zero_schedule_step_keeps_the_estimate_where_optax_gives_nan():
    """A warm-up from 0 (the schedule's factor is 0 at the first update)
    leaves prodigy's gradient sum at 0: optax divides 0 by 0 and its
    d-estimate, and from then on every parameter, is NaN (ROADMAP C.21, a
    fault of the reference pinned here).  The port keeps the estimate, so
    the step moves nothing and the next steps train."""
    kw = dict(optimizer="prodigy", learning_rate=1.0, lr_scheduler="cosine", lr_warmup_steps=2, max_train_steps=8)
    start = [np.random.RandomState(0).randn(*s).astype(np.float32) for s in SHAPES]
    tx = j_optim.make_optimizer(j_optim.OptimizerSpec(**kw))
    params_j = [jnp.asarray(x) for x in start]
    state_j = tx.init(params_j)
    opt = optim.make_optimizer(optim.OptimizerSpec(**kw))
    params = [torch.from_numpy(x.copy()) for x in start]
    state = opt.init(params)
    for step in range(3):
        g = _grads(start if step == 0 else [p.numpy() for p in params], step)
        updates, state_j = tx.update([jnp.asarray(x) for x in g], state_j, params_j)
        params_j = jax.tree.map(lambda p, u: p + u, params_j, updates)
        opt.step(params, [torch.from_numpy(x) for x in g], state)
        if step == 0:
            assert np.isnan(float(state_j.estim_lr))
            assert state["estim_lr"].item() == pytest.approx(optim.PRODIGY_ESTIM_LR0)
            assert all(torch.equal(p, torch.from_numpy(x)) for p, x in zip(params, start))
    assert all(np.isnan(np.asarray(p)).all() for p in params_j)
    assert all(bool(torch.isfinite(p).all()) for p in params)
    assert not all(torch.equal(p, torch.from_numpy(x)) for p, x in zip(params, start))


def test_prodigy_state_is_fp32_and_keeps_the_initial_point():
    opt = optim.make_optimizer(optim.OptimizerSpec(optimizer="prodigy", learning_rate=1.0))
    params = [torch.ones(3, 2), torch.zeros(4)]
    state = opt.init(params)
    params[0].add_(1.0)  # the update is in place; params0 must be a copy
    assert torch.equal(state["params0"][0], torch.ones(3, 2))
    assert state["estim_lr"].dtype == state["numerator_weighted"].dtype == torch.float32
    assert state["estim_lr"].item() == pytest.approx(optim.PRODIGY_ESTIM_LR0)
