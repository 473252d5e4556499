"""Optimizers and the cyclical learning rate, the counterpart of
`ursonet_tpu/train/optim.py`. Both clip the gradients by their global
norm at GRADIENT_CLIP_NORM first.

`KerasSGD` (OPTIMIZER='SGD') is Keras-style momentum SGD

    v ← m·v − lr_t·g ;  w ← w + v

where the learning rate multiplies only the current gradient. This is
not `torch.optim.SGD` (v ← m·v + g; w ← w − lr·v), which differs once the
learning rate varies.

`AMSGrad` (OPTIMIZER='ADAM') follows `optax.amsgrad` (b1 0.9, b2 0.999,
eps 1e-8, eps_root 0), Keras' Adam(amsgrad=True):

    m ← b1·m + (1−b1)·g ;  n ← b2·n + (1−b2)·g²
    n̂max ← max(n̂max, n / (1 − b2^t)) ;  w ← w − lr_t·(m / (1 − b1^t)) / (√n̂max + eps)

It keeps the running maximum of the bias-corrected second moment, as
optax does; `torch.optim.Adam(amsgrad=True)` keeps the maximum of the raw
moment, and the two part from the second step on.

The learning rate is a constant or a schedule of the update count
(`clr_schedule`, under CLR); each optimizer keeps the count, which a
train-state snapshot stores, so a resumed run continues the cycle.
"""

from __future__ import annotations

from typing import Callable, Union

import numpy as np
import torch
import torch.distributed as dist

Schedule = Callable[[int], float]


def clr_schedule(base_lr: float, max_lr: float, step_size: int,
                 mode: str = 'triangular', gamma: float = 1.0) -> Schedule:
    """Cyclical learning rate of the update count, in float32 as the JAX
    package computes it (reference clr_callback.py):

    triangular:  lr = base + (max − base)·max(0, 1 − x)
    triangular2: the amplitude halves each cycle
    exp_range:   the amplitude scales by gamma^count
    """
    if mode not in ('triangular', 'triangular2', 'exp_range'):
        raise ValueError(f"unknown CLR mode {mode}")
    f32 = np.float32

    def schedule(count: int) -> float:
        it = f32(count)
        cycle = np.floor(f32(1.0) + it / f32(2.0 * step_size))
        x = np.abs(it / f32(step_size) - f32(2.0) * cycle + f32(1.0))
        amp = np.maximum(f32(0.0), f32(1.0) - x)
        if mode == 'triangular':
            scale = f32(1.0)
        elif mode == 'triangular2':
            scale = f32(1.0) / (f32(2.0) ** (cycle - f32(1.0)))
        else:
            scale = f32(gamma) ** it
        return float(f32(base_lr) + f32(max_lr - base_lr) * amp * scale)

    return schedule


def _global_norm_clip(grads, clip_norm, split=None, group=None) -> None:
    """optax.clip_by_global_norm, in place: unchanged below the limit,
    else scaled to it. `split` [bool per gradient]: the gradients held as
    shards over the 'model' group `group`; their norms are the whole
    tensors', the squares of the shards summed over the group (one
    all-reduce), and every replicated tensor counts once."""
    norms = torch.stack([torch.linalg.vector_norm(g) for g in grads])
    if group is not None and any(split):
        idx = torch.tensor([i for i, s in enumerate(split) if s],
                           device=norms.device)
        sq = torch.square(norms[idx])
        dist.all_reduce(sq, group=group)
        norms = norms.index_put((idx,), torch.sqrt(sq))
    g_norm = torch.linalg.vector_norm(norms)
    factor = torch.where(g_norm < clip_norm, torch.ones_like(g_norm),
                         clip_norm / g_norm)
    for g in grads:
        g.mul_(factor)


class _Optimizer:
    """Clip, then the update of a subclass. `state` holds the slots
    (SLOTS: one tensor per parameter each), created zero at the first
    step; `count` is the number of updates so far; `last_lr` the
    learning rate of the last one."""
    SLOTS: tuple = ()

    def __init__(self, learning_rate: Union[float, Schedule],
                 clip_norm: float):
        self.learning_rate = learning_rate
        self.clip_norm = clip_norm
        self.state = None
        self.count = 0
        self.last_lr = None

    def lr_at(self, count: int) -> float:
        if callable(self.learning_rate):
            return self.learning_rate(count)
        return float(self.learning_rate)

    def reset(self) -> None:
        self.state = None
        self.count = 0

    @torch.no_grad()
    def step(self, params, grads, split=None, group=None) -> None:
        """Update `params` in place from `grads` (a list aligned with
        them; the grads are clipped in place). `split`, `group`: the
        gradients held as shards over 'model' (`_global_norm_clip`)."""
        _global_norm_clip(grads, self.clip_norm, split, group)
        if self.state is None:
            self.state = {s: [torch.zeros_like(p) for p in params]
                          for s in self.SLOTS}
        lr = self.lr_at(self.count)
        self._update(params, grads, lr)
        self.count += 1
        self.last_lr = lr

    def _update(self, params, grads, lr: float) -> None:
        raise NotImplementedError


class KerasSGD(_Optimizer):
    """Clip by global norm, then Keras momentum SGD."""
    SLOTS = ('velocity',)

    def __init__(self, learning_rate: Union[float, Schedule], momentum: float,
                 clip_norm: float):
        super().__init__(learning_rate, clip_norm)
        self.momentum = float(momentum)

    def _update(self, params, grads, lr):
        for p, v, g in zip(params, self.state['velocity'], grads):
            v.mul_(self.momentum).sub_(g, alpha=lr)
            p.add_(v)


class AMSGrad(_Optimizer):
    """Clip by global norm, then optax.amsgrad with its defaults."""
    SLOTS = ('mu', 'nu', 'nu_max')
    B1, B2, EPS = 0.9, 0.999, 1e-8

    def _update(self, params, grads, lr):
        f32 = np.float32
        b1, b2 = self.B1, self.B2
        t = self.count + 1
        bc1 = float(f32(1.0) - f32(b1) ** f32(t))
        bc2 = float(f32(1.0) - f32(b2) ** f32(t))
        st = self.state
        for p, g, m, n, nmax in zip(params, grads, st['mu'], st['nu'],
                                    st['nu_max']):
            m.copy_((1.0 - b1) * g + b1 * m)
            n.copy_((1.0 - b2) * (g * g) + b2 * n)
            torch.maximum(nmax, n / bc2, out=nmax)
            p.add_((m / bc1) / (torch.sqrt(nmax) + self.EPS) * -lr)


def make_optimizer(config) -> _Optimizer:
    """The optimizer of a Config: OPTIMIZER 'SGD' or 'ADAM', with the
    triangular cyclical learning rate under CLR (BASE_LEARNING_RATE to
    MAX_LEARNING_RATE over CLR_STEP_SIZE updates), else LEARNING_RATE."""
    if config.CLR:
        lr = clr_schedule(config.BASE_LEARNING_RATE, config.MAX_LEARNING_RATE,
                          config.CLR_STEP_SIZE, mode='triangular')
    else:
        lr = config.LEARNING_RATE
    name = config.OPTIMIZER.upper()
    if name == 'SGD':
        return KerasSGD(lr, config.LEARNING_MOMENTUM,
                        config.GRADIENT_CLIP_NORM)
    if name == 'ADAM':
        return AMSGrad(lr, config.GRADIENT_CLIP_NORM)
    raise ValueError(f"OPTIMIZER={config.OPTIMIZER!r}: 'SGD' or 'ADAM'")
