"""Seeded float weights for a model's state dict, made on its device in a
few large calls.

Conv and dense kernels are normal with the LeCun fan-in scale,
N(0, 1 / fan_in); biases N(0, 0.02²). Batch norms are made away from the
identity so that folding them is exercised: scale U(0.8, 1.2), shift
N(0, 0.05²), running mean N(0, 0.05²), running variance U(0.8, 1.2); the
last batch norm of each residual branch (`bn*_branch2c`) scales by a tenth
of that, U(0.08, 0.12), as ResNets are initialised for training (each
block starts near the identity), and the stem's (`bn_conv1`) running
variance is that of its conv's output over uniform uint8 pixels (255² / 12
times U(0.8, 1.2)), as a model trained on such images holds it: so the
activations, the head outputs and the losses stay of the size a trained
model's have. The same seed gives the same weights on the same device.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

# variance of a uniform uint8 pixel
PIXEL_VAR = 255.0 ** 2 / 12.0


def _role(name: str, shape) -> str:
    mod, leaf = name.rsplit('.', 1)
    layer = mod.rsplit('.', 1)[-1]
    if leaf in ('running_mean', 'running_var'):
        return leaf
    if layer.startswith('bn') or '_bn_' in layer:
        return 'bn_' + leaf
    return 'kernel' if leaf == 'weight' and len(shape) >= 2 else 'bias'


def make_weights(shapes: Dict[str, tuple], seed: int,
                 device) -> Dict[str, torch.Tensor]:
    """{name: float32 tensor} for {name: shape} (a state dict's float
    entries), from `seed`, on `device`."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    names = list(shapes)
    sizes = [math.prod(shapes[n]) for n in names]
    total = sum(sizes)
    normal = torch.randn(total, generator=gen, device=dev)
    uniform = torch.rand(total, generator=gen, device=dev)
    out, at = {}, 0
    for name, size in zip(names, sizes):
        shape = shapes[name]
        n = normal[at:at + size].view(shape)
        u = uniform[at:at + size].view(shape)
        at += size
        role = _role(name, shape)
        if role == 'kernel':
            fan_in = math.prod(shape[1:])
            t = n * math.sqrt(1.0 / fan_in)
        elif role == 'bias':
            t = n * 0.02
        elif role == 'bn_weight' and '_branch2c.' in name:
            t = 0.08 + 0.04 * u
        elif role == 'running_var' and name.endswith('bn_conv1.running_var'):
            t = (0.8 + 0.4 * u) * PIXEL_VAR
        elif role in ('bn_weight', 'running_var'):
            t = 0.8 + 0.4 * u
        else:   # bn_bias, running_mean
            t = n * 0.05
        out[name] = t.contiguous()
    return out
