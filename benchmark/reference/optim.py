"""The plain reference of the trainer's optimizer: clipping by the global
gradient norm, then AdamW (bias-corrected moments, decoupled weight decay
added to the update, a constant learning rate), in fp32."""

from __future__ import annotations

from typing import List

import torch


class AdamW:
    def __init__(self, params: List[torch.Tensor], lr: float, beta1: float, beta2: float, eps: float,
                 weight_decay: float, max_grad_norm: float):
        self.params, self.lr, self.b1, self.b2 = params, lr, beta1, beta2
        self.eps, self.wd, self.clip = eps, weight_decay, max_grad_norm
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]
        self.count = 0

    @torch.no_grad()
    def clipped(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """The gradients as the update sees them."""
        if not self.clip:
            return grads
        norm = torch.sqrt(sum(g.double().square().sum() for g in grads)).float()
        return grads if norm < self.clip else [g * (self.clip / norm) for g in grads]

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """Update the params in place; returns the clipped gradients."""
        grads = self.clipped(grads)
        self.count += 1
        bc1, bc2 = 1.0 - self.b1 ** self.count, 1.0 - self.b2 ** self.count
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            mu.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            nu.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            update = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps) + self.wd * p
            p.sub_(self.lr * update)
        return grads
