"""Optimizer and LR schedules of the trainers (counterpart of
``s2v_tpu/training/optim.py``): global-norm clipping, then adam, adamw or
prodigy on a schedule with warm-up, then gradient accumulation.

The JAX package builds these as one optax chain; here they are plain tensor
code with the same arithmetic, so that the first moment can be kept in bf16
while the parameters are fp32 (``torch.optim.AdamW`` cannot), and clipping
divides by the norm itself (``torch.nn.utils.clip_grad_norm_`` adds 1e-6).
Steps count as optax counts them: the first update uses ``schedule(0)`` and
Adam's bias correction for step 1.  Accumulation follows
``optax.MultiSteps``: the mean of k micro-steps' grads, and the update and
the step count move only on the k-th.  Updates are applied in place.

Prodigy is ``optax.contrib.prodigy`` (optax 0.2.6) at its defaults but for
what the trainer passes (the schedule as a multiplicative factor on the
d-estimate, betas, eps, weight decay): beta3 = sqrt(beta2), initial
estimate 1e-6, no safeguard warm-up; one repair (ROADMAP C.21): a step
whose schedule factor is 0 keeps the d-estimate instead of optax's 0/0 NaN.
Its scalars (the d-estimate and the
weighted numerator) stay fp32 tensors on the parameters' device, so a step
needs no host sync.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, List, Optional

import torch

SCHEDULES = ("constant", "constant_with_warmup", "linear", "cosine")
OPTIMIZERS = ("adamw", "adam", "prodigy")
MOMENT_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# optax.contrib.prodigy's initial (under-)estimate of the learning rate
PRODIGY_ESTIM_LR0 = 1e-6


@dataclass(frozen=True)
class OptimizerSpec:
    """The reference trainer template's optimizer flags."""

    optimizer: str = "adamw"
    learning_rate: float = 1e-4
    lr_scheduler: str = "constant"
    lr_warmup_steps: int = 0
    max_train_steps: int = 1000  # decay horizon for linear/cosine
    max_grad_norm: Optional[float] = None  # template default 1.0; None = off
    weight_decay: float = 1e-4
    beta1: float = 0.9
    beta2: float = 0.95
    epsilon: float = 1e-8
    gradient_accumulation_steps: int = 1
    # storage dtype of Adam's first moment; the second stays fp32
    moment_dtype: str = "float32"

    def __post_init__(self):
        if self.optimizer not in OPTIMIZERS:
            raise ValueError(f"optimizer must be one of {OPTIMIZERS}, got {self.optimizer!r}")
        if self.lr_scheduler not in SCHEDULES:
            raise ValueError(f"lr_scheduler must be one of {SCHEDULES}, got {self.lr_scheduler!r}")
        if self.gradient_accumulation_steps < 1:
            raise ValueError("gradient_accumulation_steps must be >= 1")
        if self.moment_dtype not in MOMENT_DTYPES:
            raise ValueError(f"moment_dtype must be 'float32' or 'bfloat16', got {self.moment_dtype!r}")
        if self.optimizer == "prodigy" and self.moment_dtype != "float32":
            raise ValueError(
                "moment_dtype='bfloat16' is not supported with optimizer='prodigy' "
                "(prodigy keeps fp32 state); use adam/adamw for low-precision moments"
            )


def _linear(init: float, end: float, steps: int) -> Callable[[int], float]:
    """optax.linear_schedule: init -> end over ``steps``, then end."""
    if steps <= 0:
        return lambda count: init
    return lambda count: (init - end) * (1.0 - min(max(count, 0), steps) / steps) + end


def make_lr_schedule(spec: OptimizerSpec) -> Callable[[int], float]:
    """Step count -> learning rate: constant, constant_with_warmup, linear
    or cosine, each with a linear warm-up from 0 (the diffusers names, as
    the optax schedules of the JAX package compute them)."""
    lr, warm = spec.learning_rate, int(spec.lr_warmup_steps)
    total = max(int(spec.max_train_steps), warm + 1)
    if spec.lr_scheduler == "constant" or (spec.lr_scheduler == "constant_with_warmup" and warm == 0):
        return lambda count: lr
    if spec.lr_scheduler == "constant_with_warmup":
        up = _linear(0.0, lr, warm)
        return lambda count: up(count) if count < warm else lr
    if spec.lr_scheduler == "linear":
        if not warm:
            return _linear(lr, 0.0, total)
        up, down = _linear(0.0, lr, warm), _linear(lr, 0.0, total - warm)
        return lambda count: up(count) if count < warm else down(count - warm)
    # cosine: optax.warmup_cosine_decay_schedule(0, lr, warm, total)
    up = _linear(0.0, lr, warm)
    decay = total - warm

    def cosine(count: int) -> float:
        if count < warm:
            return up(count)
        c = min(count - warm, decay)
        return lr * 0.5 * (1.0 + math.cos(math.pi * c / decay))

    return cosine


class Optimizer:
    """[global-norm clip] -> adam/adamw/prodigy on a schedule [->
    accumulation], on a flat list of tensors.  ``init(params)`` returns the
    state; ``step(params, grads, state)`` updates params and state in
    place.

    ``global_sum`` adds per-leaf sums into one total: the default, a sum in
    leaf order, sees whole leaves; a sharded trainer (FSDP, megatron TP:
    ``training/full.py``) passes one that also adds the other ranks'
    shards, so the clip norm and prodigy's d-estimate are the whole tree's
    on every rank."""

    def __init__(self, spec: OptimizerSpec, global_sum: Optional[Callable[[List[torch.Tensor]], torch.Tensor]] = None):
        self.spec = spec
        self.schedule = make_lr_schedule(spec)
        self.mu_dtype = MOMENT_DTYPES[spec.moment_dtype]
        self.global_sum = global_sum or (lambda values: sum(values))

    def init(self, params: List[torch.Tensor]) -> dict:
        if self.spec.optimizer == "prodigy":
            # optax's ProdigyState: moments, the weighted gradient sum, the
            # initial point, the d-estimate and the weighted numerator
            device = params[0].device
            state = {
                "count": 0,
                "exp_avg": [torch.zeros_like(p) for p in params],
                "exp_avg_sq": [torch.zeros_like(p) for p in params],
                "grad_sum": [torch.zeros_like(p) for p in params],
                "params0": [p.detach().clone() for p in params],
                "estim_lr": torch.tensor(PRODIGY_ESTIM_LR0, dtype=torch.float32, device=device),
                "numerator_weighted": torch.zeros((), dtype=torch.float32, device=device),
            }
        else:
            state = {
                "count": 0,  # updates applied so far (Adam's and the schedule's count)
                "mu": [torch.zeros_like(p, dtype=self.mu_dtype) for p in params],
                "nu": [torch.zeros_like(p, dtype=torch.float32) for p in params],
            }
        if self.spec.gradient_accumulation_steps > 1:
            state["mini_step"] = 0
            state["acc"] = [torch.zeros_like(p) for p in params]
        return state

    @torch.no_grad()
    def step(self, params: List[torch.Tensor], grads: List[torch.Tensor], state: dict) -> None:
        k = self.spec.gradient_accumulation_steps
        if k > 1:
            n = state["mini_step"]
            for acc, g in zip(state["acc"], grads):
                acc.add_((g - acc) / (n + 1))  # running mean (optax.MultiSteps' Welford form)
            if n < k - 1:
                state["mini_step"] = n + 1
                return
            grads = [acc.clone() for acc in state["acc"]]
            for acc in state["acc"]:
                acc.zero_()
            state["mini_step"] = 0
        self._update(params, grads, state)

    def _update(self, params, grads, state) -> None:
        spec = self.spec
        if spec.max_grad_norm is not None and spec.max_grad_norm > 0:
            g_norm = torch.sqrt(self.global_sum([g.float().square().sum() for g in grads]))
            keep = g_norm < spec.max_grad_norm
            grads = [torch.where(keep, g, g / g_norm.to(g.dtype) * spec.max_grad_norm) for g in grads]
        if spec.optimizer == "prodigy":
            self._prodigy(params, grads, state)
            return
        b1, b2 = spec.beta1, spec.beta2
        t = state["count"] + 1
        bc1, bc2 = 1.0 - b1**t, 1.0 - b2**t
        lr = self.schedule(state["count"])
        for i, (p, g) in enumerate(zip(params, grads)):
            mu = g * (1.0 - b1) + (state["mu"][i] * b1).to(g.dtype)
            nu = g.square() * (1.0 - b2) + state["nu"][i] * b2
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + spec.epsilon)
            if spec.optimizer == "adamw":
                u = u + spec.weight_decay * p
            p.add_(u * -lr)
            state["mu"][i] = mu.to(self.mu_dtype)
            state["nu"][i] = nu
        state["count"] = t

    def _prodigy(self, params, grads, state) -> None:
        """One ``optax.contrib.prodigy`` update, in its order: the old
        d-estimate scales the gradients and the step size; the new one, the
        larger of the old and the weighted numerator over the gradient
        sum's L1 norm, enters only the epsilon term."""
        spec = self.spec
        b1, b2 = spec.beta1, spec.beta2
        b3 = b2 ** 0.5
        t = state["count"] + 1
        bc = ((1 - b2 ** t) ** 0.5) / (1 - b1 ** t)
        d = state["estim_lr"]
        dlr = d * self.schedule(state["count"]) * bc
        numerator = self.global_sum([(g * (p0 - p)).sum() for g, p0, p in zip(grads, state["params0"], params)])
        for i, g in enumerate(grads):
            dg = d * g
            state["exp_avg"][i] = b1 * state["exp_avg"][i] + (1 - b1) * dg
            state["exp_avg_sq"][i] = b2 * state["exp_avg_sq"][i] + (1 - b2) * dg * dg
            state["grad_sum"][i] = b3 * state["grad_sum"][i] + dlr * dg / PRODIGY_ESTIM_LR0
        state["numerator_weighted"] = (b3 * state["numerator_weighted"]
                                       + (d / PRODIGY_ESTIM_LR0) * dlr * numerator)
        denominator = self.global_sum([gs.abs().sum() for gs in state["grad_sum"]])
        # a step whose schedule factor is 0 (a warm-up's first) leaves the
        # gradient sum, and so the denominator, at 0: optax's 0/0 turns the
        # estimate, and every later update, into NaN (ROADMAP C.21); the
        # estimate stays where it was instead, as prodigyopt's early return does
        estimate = torch.where(denominator > 0, state["numerator_weighted"] / denominator, torch.zeros_like(d))
        state["estim_lr"] = torch.maximum(d, estimate)
        for p, ea, eas in zip(params, state["exp_avg"], state["exp_avg_sq"]):
            p.add_(-spec.weight_decay * dlr * p - dlr * ea / (torch.sqrt(eas) + state["estim_lr"] * spec.epsilon))
        state["count"] = t


def make_optimizer(spec: OptimizerSpec, global_sum=None) -> Optimizer:
    return Optimizer(spec, global_sum)
