"""ResNet-50 backbone on [N,C,H,W] tensors, the counterpart of
`ursonet_tpu/models/resnet.py` (`FrozenAwareBN`, `BottleneckBlock`,
`ResNetBackbone`).

Module names are the reference's Keras layer names ('conv1', 'bn_conv1',
'res3a' > 'res3a_branch2a', 'bn3a_branch2a', ...), so a JAX parameter
tree converts name for name (`checkpoint/convert.py`).

Semantics kept from the JAX package:
  * Batch norm with Keras' epsilon 1e-3. TRAIN_BN=False (the only mode
    this slice ports) always normalizes with the running statistics and
    never updates them; the affine weight and bias still train.
  * Stem: explicit (3,3) zero pad, then a VALID 7×7/2 conv.
  * Flax 'SAME' at stride 2 pads (0,1) on even sizes, not (1,1): the
    3×3/2 maxpool gets that padding explicitly (with -inf), as does the
    3×3/2 bottleneck conv of `models/ursonet.py`.
  * Conv-block shortcuts and the '2a' convs are 1×1 with the block's
    stride, VALID.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

# Keras BatchNormalization default
BN_EPS = 1e-3


def same_pads(n: int, k: int, s: int) -> tuple[int, int]:
    """(low, high) padding of TF/Flax 'SAME' for size n, kernel k,
    stride s: the odd pixel goes to the high side."""
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def pad_same(x: torch.Tensor, k: int, s: int, value: float = 0.0):
    """Pad [N,C,H,W] `x` as 'SAME' would for a k×k/s window."""
    top, bottom = same_pads(x.shape[2], k, s)
    left, right = same_pads(x.shape[3], k, s)
    if top or bottom or left or right:
        x = F.pad(x, (left, right, top, bottom), value=value)
    return x


class FrozenBN(nn.Module):
    """Batch norm with frozen statistics (TRAIN_BN=False): running mean
    and variance are buffers that are always used and never updated; the
    affine weight and bias are trainable parameters."""

    def __init__(self, num_features: int, train_bn=False):
        super().__init__()
        if train_bn is not False:
            raise NotImplementedError(
                f"TRAIN_BN={train_bn!r}: batch-statistics BN is ported in a "
                "later slice; this slice ports TRAIN_BN=False")
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, training=False,
                            momentum=0.0, eps=BN_EPS)


class BottleneckBlock(nn.Module):
    """Bottleneck residual block: identity block, or conv block when
    `conv_shortcut` (a 1×1/s conv + BN on the shortcut)."""

    def __init__(self, in_ch: int, filters, stage: int, block: str,
                 strides: int = 1, conv_shortcut: bool = False,
                 train_bn=False):
        super().__init__()
        f1, f2, f3 = filters
        self.cname = f"res{stage}{block}_branch"
        self.bname = f"bn{stage}{block}_branch"
        c, b = self.cname, self.bname
        self.add_module(c + '2a', nn.Conv2d(in_ch, f1, 1, strides))
        self.add_module(b + '2a', FrozenBN(f1, train_bn))
        self.add_module(c + '2b', nn.Conv2d(f1, f2, 3, 1, padding=1))
        self.add_module(b + '2b', FrozenBN(f2, train_bn))
        self.add_module(c + '2c', nn.Conv2d(f2, f3, 1, 1))
        self.add_module(b + '2c', FrozenBN(f3, train_bn))
        self.conv_shortcut = conv_shortcut
        if conv_shortcut:
            self.add_module(c + '1', nn.Conv2d(in_ch, f3, 1, strides))
            self.add_module(b + '1', FrozenBN(f3, train_bn))

    def forward(self, x):
        m = self._modules
        c, b = self.cname, self.bname
        y = F.relu(m[b + '2a'](m[c + '2a'](x)), inplace=True)
        y = F.relu(m[b + '2b'](m[c + '2b'](y)), inplace=True)
        y = m[b + '2c'](m[c + '2c'](y))
        sc = m[b + '1'](m[c + '1'](x)) if self.conv_shortcut else x
        return F.relu(y + sc, inplace=True)


class ResNetBackbone(nn.Module):
    """ResNet-50 feature extractor; returns C5 [N,2048,H/32,W/32]."""

    def __init__(self, architecture: str = 'resnet50', train_bn=False):
        super().__init__()
        if architecture != 'resnet50':
            raise NotImplementedError(
                f"backbone {architecture!r}: this port has resnet50; "
                "resnet18/34/101 come in a later slice")
        self.conv1 = nn.Conv2d(3, 64, 7, 2, padding=3)
        self.bn_conv1 = FrozenBN(64, train_bn)
        self.blocks = []
        in_ch = 64

        def blk(filters, stage, block, strides=1, conv_shortcut=False):
            nonlocal in_ch
            name = f'res{stage}{block}'
            self.add_module(name, BottleneckBlock(
                in_ch, filters, stage, block, strides, conv_shortcut,
                train_bn))
            self.blocks.append(name)
            in_ch = filters[2]

        blk((64, 64, 256), 2, 'a', 1, True)
        blk((64, 64, 256), 2, 'b')
        blk((64, 64, 256), 2, 'c')
        blk((128, 128, 512), 3, 'a', 2, True)
        for b in 'bcd':
            blk((128, 128, 512), 3, b)
        blk((256, 256, 1024), 4, 'a', 2, True)
        for b in 'bcdef':
            blk((256, 256, 1024), 4, b)
        blk((512, 512, 2048), 5, 'a', 2, True)
        blk((512, 512, 2048), 5, 'b')
        blk((512, 512, 2048), 5, 'c')

    def forward(self, x):
        y = F.relu(self.bn_conv1(self.conv1(x)), inplace=True)
        y = F.max_pool2d(pad_same(y, 3, 2, float('-inf')), 3, 2)
        for name in self.blocks:
            y = self._modules[name](y)
        return y
