"""Adam (Kingma and Ba 2015) as torch.optim.Adam defines it, on a dict of
float32 leaves."""

from __future__ import annotations

import math

import torch


class Adam:
    def __init__(self, params: dict, betas=(0.9, 0.999), eps: float = 1e-8):
        self.params = params
        self.b1, self.b2 = betas
        self.eps = eps
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    def step(self, grads: dict, lr: float) -> None:
        self.t += 1
        c1, c2 = 1.0 - self.b1**self.t, 1.0 - self.b2**self.t
        with torch.no_grad():
            for k, p in self.params.items():
                g = grads[k]
                self.m[k].mul_(self.b1).add_(g, alpha=1.0 - self.b1)
                self.v[k].mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
                denom = (self.v[k].sqrt() / math.sqrt(c2)).add_(self.eps)
                p.addcdiv_(self.m[k], denom, value=-lr / c1)
