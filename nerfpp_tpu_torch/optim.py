"""Adam with an exponential learning-rate decay, as optax computes it
(the JAX package's ``optax.adam(exponential_decay(...), b1, b2, eps)``).

A dense update of every entry, untouched table rows included: no sparse or
lazy Adam. The moments live beside the parameters under the same names;
``count`` is the number of updates applied, a device scalar. ``step`` takes
the update only where ``ok`` holds (a device bool), so a step whose loss is
not finite leaves parameters, moments and count as they were without a host
round trip.
"""
from __future__ import annotations

from typing import Dict

import torch


class Adam:
    def __init__(self, params: Dict[str, torch.nn.Parameter], lr: float,
                 decay_steps: int, decay_rate: float = 0.1, b1: float = 0.9,
                 b2: float = 0.99, eps: float = 1e-15):
        self.params = params
        self.lr, self.decay_steps, self.decay_rate = lr, decay_steps, decay_rate
        self.b1, self.b2, self.eps = b1, b2, eps
        dev = next(iter(params.values())).device
        self.mu = {k: torch.zeros_like(p, memory_format=torch.contiguous_format)
                   for k, p in params.items()}
        self.nu = {k: torch.zeros_like(p, memory_format=torch.contiguous_format)
                   for k, p in params.items()}
        self.count = torch.zeros((), dtype=torch.int32, device=dev)

    def learning_rate(self) -> torch.Tensor:
        """lr * decay_rate ** (count / decay_steps), continuous (no
        staircase), at the count before this update."""
        p = self.count.float() / float(self.decay_steps)
        return self.lr * torch.pow(
            torch.tensor(self.decay_rate, device=p.device), p)

    @torch.no_grad()
    def step(self, ok: torch.Tensor) -> None:
        """One update from each parameter's ``.grad`` (zero where None)."""
        lr = self.learning_rate()
        count = self.count + 1
        bc1 = 1.0 - torch.pow(torch.tensor(self.b1, device=lr.device),
                              count.float())
        bc2 = 1.0 - torch.pow(torch.tensor(self.b2, device=lr.device),
                              count.float())
        for k, p in self.params.items():
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            mu = (1.0 - self.b1) * g + self.b1 * self.mu[k]
            nu = (1.0 - self.b2) * (g * g) + self.b2 * self.nu[k]
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            p.copy_(torch.where(ok, p - lr * u, p))
            self.mu[k].copy_(torch.where(ok, mu, self.mu[k]))
            self.nu[k].copy_(torch.where(ok, nu, self.nu[k]))
        self.count.copy_(torch.where(ok, count, self.count))
