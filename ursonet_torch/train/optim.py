"""Optimizer, the counterpart of `ursonet_tpu/train/optim.py` for the SGD
recipe: global-norm gradient clipping at GRADIENT_CLIP_NORM, then
Keras-style momentum SGD

    v ← m·v − lr·g ;  w ← w + v

where the learning rate multiplies only the current gradient. This is
not `torch.optim.SGD` (v ← m·v + g; w ← w − lr·v), which differs once the
learning rate varies. Cyclical LR and Adam come in a later slice.
"""

from __future__ import annotations

import torch


class KerasSGD:
    """Clip by global norm, then Keras momentum SGD. The velocity is
    created at the first step, zero, one tensor per parameter."""

    def __init__(self, learning_rate: float, momentum: float,
                 clip_norm: float):
        self.learning_rate = float(learning_rate)
        self.momentum = float(momentum)
        self.clip_norm = clip_norm
        self.velocity = None

    @torch.no_grad()
    def step(self, params, grads) -> None:
        """Update `params` in place from `grads` (a list aligned with
        them; the grads are clipped in place)."""
        g_norm = torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(g) for g in grads]))
        # optax.clip_by_global_norm: unchanged below the limit, else
        # scaled to it
        factor = torch.where(g_norm < self.clip_norm,
                             torch.ones_like(g_norm), self.clip_norm / g_norm)
        for g in grads:
            g.mul_(factor)
        if self.velocity is None:
            self.velocity = [torch.zeros_like(p) for p in params]
        for p, v, g in zip(params, self.velocity, grads):
            v.mul_(self.momentum).sub_(g, alpha=self.learning_rate)
            p.add_(v)


def make_optimizer(config) -> KerasSGD:
    if config.CLR:
        raise NotImplementedError("CLR: the cyclical learning rate is "
                                  "ported in a later slice")
    if config.OPTIMIZER.upper() != 'SGD':
        raise NotImplementedError(f"OPTIMIZER={config.OPTIMIZER!r}: Adam is "
                                  "ported in a later slice")
    return KerasSGD(config.LEARNING_RATE, config.LEARNING_MOMENTUM,
                    config.GRADIENT_CLIP_NORM)
