"""Pose head on the flattened bottleneck features, the counterpart of
`ursonet_tpu/models/heads.py::PoseHead`.

NR_DENSE_LAYERS × (Dense(BRANCH_SIZE) + ReLU), then a final Dense:
linear (location regression), ReLU (soft-classification logits) or
L2-normalized (quaternion regression). Layer names are the Keras ones:
'{prefix}_dense_{i}' and the final layer's own name.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ursonet_torch.models.resnet import Linear


class PoseHead(nn.Module):

    def __init__(self, prefix: str, in_features: int, nr_dense_layers: int,
                 branch_size: int, final_features: int,
                 final_activation: str, final_name: str, train_bn=False):
        super().__init__()
        if train_bn:
            raise NotImplementedError(
                "TRAIN_BN: head batch norm is ported in a later slice")
        if final_activation not in ('linear', 'relu', 'l2norm'):
            raise ValueError(f"unknown activation {final_activation!r}")
        self.dense = []
        for i in range(nr_dense_layers):
            name = f"{prefix}_dense_{i}"
            self.add_module(name, Linear(in_features, branch_size))
            self.dense.append(name)
            in_features = branch_size
        self.final_name = final_name
        self.add_module(final_name, Linear(in_features, final_features))
        self.final_activation = final_activation

    def forward(self, x):
        for name in self.dense:
            x = F.relu(self._modules[name](x), inplace=True)
        out = self._modules[self.final_name](x)
        if self.final_activation == 'relu':
            out = F.relu(out)
        elif self.final_activation == 'l2norm':
            # x / sqrt(max(sum(x²), 1e-12)): zero-safe
            sq = torch.sum(torch.square(out), dim=-1, keepdim=True)
            out = out * torch.rsqrt(torch.clamp(sq, min=1e-12))
        return out
