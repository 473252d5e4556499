"""Heads on the flattened bottleneck features, the counterparts of
`ursonet_tpu/models/heads.py::PoseHead` and `KeypointHead`.

Both start with NR_DENSE_LAYERS × (Dense(BRANCH_SIZE) [+ BN under
TRAIN_BN=True] + ReLU). PoseHead
then has one final Dense: linear (location regression), ReLU
(soft-classification logits) or L2-normalized (quaternion regression).
KeypointHead has three linear Dense(3) finals, k1/k2/k3. Layer names are
the Keras ones: '{prefix}_dense_{i}', '{prefix}_bn_{i}' and the final
layers' own names.
Under F16 they compute in bf16 like the backbone (`Linear`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ursonet_torch.models.resnet import FrozenBN, Linear


class _DenseStack(nn.Module):
    """The hidden '{prefix}_dense_{i}' layers, each Dense, then under a
    truthy TRAIN_BN (True; None is falsy here, as in the JAX heads) the
    batch norm '{prefix}_bn_{i}', then ReLU."""

    def __init__(self, prefix: str, in_features: int, nr_dense_layers: int,
                 branch_size: int, train_bn=False):
        super().__init__()
        self.dense = []
        for i in range(nr_dense_layers):
            layers = [f"{prefix}_dense_{i}"]
            self.add_module(layers[0], Linear(in_features, branch_size))
            if train_bn:
                layers.append(f"{prefix}_bn_{i}")
                self.add_module(layers[1], FrozenBN(branch_size, train_bn))
            self.dense.append(layers)
            in_features = branch_size
        self.out_features = in_features

    def hidden(self, x):
        for layers in self.dense:
            for name in layers:
                x = self._modules[name](x)
            x = F.relu(x, inplace=True)
        return x


class PoseHead(_DenseStack):

    def __init__(self, prefix: str, in_features: int, nr_dense_layers: int,
                 branch_size: int, final_features: int,
                 final_activation: str, final_name: str, train_bn=False):
        super().__init__(prefix, in_features, nr_dense_layers, branch_size,
                         train_bn)
        if final_activation not in ('linear', 'relu', 'l2norm'):
            raise ValueError(f"unknown activation {final_activation!r}")
        self.final_name = final_name
        self.add_module(final_name, Linear(self.out_features, final_features))
        self.final_activation = final_activation

    def forward(self, x):
        out = self._modules[self.final_name](self.hidden(x))
        if self.final_activation == 'relu':
            out = F.relu(out)
        elif self.final_activation == 'l2norm':
            # x / sqrt(max(sum(x²), 1e-12)): zero-safe
            sq = torch.sum(torch.square(out), dim=-1, keepdim=True)
            out = out * torch.rsqrt(torch.clamp(sq, min=1e-12))
        return out


class KeypointHead(_DenseStack):
    """Keypoint-mode location head: the 'loc' dense stack, then three
    Dense(3) outputs k1_final, k2_final, k3_final."""

    def __init__(self, in_features: int, nr_dense_layers: int,
                 branch_size: int, train_bn=False):
        super().__init__('loc', in_features, nr_dense_layers, branch_size,
                         train_bn)
        for name in ('k1_final', 'k2_final', 'k3_final'):
            self.add_module(name, Linear(self.out_features, 3))

    def forward(self, x):
        x = self.hidden(x)
        return self.k1_final(x), self.k2_final(x), self.k3_final(x)
