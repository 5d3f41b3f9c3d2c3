"""Optimizer and LR schedules of the trainers (counterpart of
``s2v_tpu/training/optim.py``): global-norm clipping, then adam/adamw on a
schedule with warm-up, then gradient accumulation.

The JAX package builds these as one optax chain; here they are plain tensor
code with the same arithmetic, so that the first moment can be kept in bf16
while the parameters are fp32 (``torch.optim.AdamW`` cannot), and clipping
divides by the norm itself (``torch.nn.utils.clip_grad_norm_`` adds 1e-6).
Steps count as optax counts them: the first update uses ``schedule(0)`` and
Adam's bias correction for step 1.  Accumulation follows
``optax.MultiSteps``: the mean of k micro-steps' grads, and the update and
the step count move only on the k-th.  Updates are applied in place.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, List, Optional

import torch

SCHEDULES = ("constant", "constant_with_warmup", "linear", "cosine")
OPTIMIZERS = ("adamw", "adam", "prodigy")
MOMENT_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


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
    """[global-norm clip] -> adam/adamw on a schedule [-> accumulation], on
    a flat list of tensors.  ``init(params)`` returns the state;
    ``step(params, grads, state)`` updates params and state in place."""

    def __init__(self, spec: OptimizerSpec):
        if spec.optimizer == "prodigy":
            raise NotImplementedError("optimizer='prodigy' is not ported yet; use adam or adamw")
        self.spec = spec
        self.schedule = make_lr_schedule(spec)
        self.mu_dtype = MOMENT_DTYPES[spec.moment_dtype]

    def init(self, params: List[torch.Tensor]) -> dict:
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
            g_norm = torch.sqrt(sum(g.float().square().sum() for g in grads))
            keep = g_norm < spec.max_grad_norm
            grads = [torch.where(keep, g, g / g_norm.to(g.dtype) * spec.max_grad_norm) for g in grads]
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


def make_optimizer(spec: OptimizerSpec) -> Optimizer:
    return Optimizer(spec)
