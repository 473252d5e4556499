"""Heads on the flattened bottleneck features, the counterparts of
`ursonet_tpu/models/heads.py::PoseHead` and `KeypointHead`.

Both start with NR_DENSE_LAYERS × (Dense(BRANCH_SIZE) [+ BN under
TRAIN_BN=True] + ReLU). PoseHead
then has one final Dense: linear (location regression), ReLU
(soft-classification logits) or L2-normalized (quaternion regression).
KeypointHead has three linear Dense(3) finals, k1/k2/k3. HeatmapHead,
the landmark model's (BACKBONE 'hrnet_w32'), is HRNet's `final_layer`
instead: a 1×1 conv with bias from the backbone's features to one
heatmap a landmark. Layer names are
the Keras ones: '{prefix}_dense_{i}', '{prefix}_bn_{i}' and the final
layers' own names.
Under F16 they compute in bf16 like the backbone (`Linear`).

Tensor parallelism (`shard_heads`, under a mesh whose 'model' axis
splits): each hidden dense becomes a `ColumnParallelLinear` that holds
its shard of the out features, each head batch norm its slice of the
features (normalizing its own slice), and the final dense a
`RowParallelLinear` that holds its shard of the in features, the
Megatron pattern of the JAX package's annotations: the column-parallel
input is the identity forward and an all-reduce backward, the
row-parallel output an all-reduce forward and the identity backward,
and the bias is added once, after the reduce. A second hidden dense and
the keypoint head's whole `k*_final` take the whole activation, and the
column-parallel final of NR_DENSE_LAYERS == 0 gives the whole output: an
all-reduce of the zero-padded shard (`parallel/sharding.py::
gather_from`), which gloo also runs on CUDA tensors.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ursonet_torch.models.resnet import Conv2d, FrozenBN, Linear
from ursonet_torch.parallel.mesh import AXIS_MODEL
from ursonet_torch.parallel.sharding import copy_to, gather_from, \
    reduce_from, split_bounds


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
        self.final_names = (final_name,)

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
        self.final_names = ()
        # the whole hidden activation for the whole finals, under a
        # split 'model' axis (`shard_heads`)
        self.gather_hidden = None

    def forward(self, x):
        x = self.hidden(x)
        if self.gather_hidden is not None:
            x = self.gather_hidden(x)
        return self.k1_final(x), self.k2_final(x), self.k3_final(x)


class HeatmapHead(nn.Module):
    """[N,C,h,w] features -> [N,K,h,w] heatmaps: `final_layer`, a 1×1 conv
    with bias (HRNet's FINAL_CONV_KERNEL 1)."""

    def __init__(self, in_channels: int, landmarks: int):
        super().__init__()
        self.final_layer = Conv2d(in_channels, landmarks, 1)

    def forward(self, x):
        return self.final_layer(x)


# ---------------------------------------------------------------------------
# tensor parallelism


class _Shard(nn.Module):
    """Where a layer's shard lies: shard `index` of `parts` over the
    'model' group `group`."""

    def __init__(self, group, index: int, parts: int):
        super().__init__()
        self.group, self.index, self.parts = group, index, parts

    def bounds(self, n: int):
        return split_bounds(n, self.parts, self.index)


def _linear(x, weight, bias=None):
    """The port's `Linear` arithmetic: F.linear in the input's dtype."""
    if x.dtype == weight.dtype:
        return F.linear(x, weight, bias)
    y = F.linear(x, weight.to(x.dtype))
    return y if bias is None else y + bias.to(x.dtype)


class ColumnParallelLinear(_Shard):
    """A dense with its out features split: weight [hi − lo, in], bias
    [hi − lo]. `gather_input`: the input arrives as the previous
    column-parallel layer's shard and is made whole first;
    `gather_output`: the output is made whole (the final dense of
    NR_DENSE_LAYERS == 0)."""

    def __init__(self, full: nn.Linear, group, index: int, parts: int,
                 gather_input: bool = False, gather_output: bool = False):
        super().__init__(group, index, parts)
        self.in_features, self.out_features = full.in_features, \
            full.out_features
        self.lo, self.hi = self.bounds(self.out_features)
        self.weight = nn.Parameter(full.weight.detach()[self.lo:self.hi]
                                   .clone())
        self.bias = nn.Parameter(full.bias.detach()[self.lo:self.hi].clone())
        self.gather_input = gather_input
        self.gather_output = gather_output

    def forward(self, x):
        if self.gather_input:
            x = gather_from(x, self.group, self.in_features,
                            *self.bounds(self.in_features))
        y = _linear(copy_to(x, self.group), self.weight, self.bias)
        if self.gather_output:
            y = gather_from(y, self.group, self.out_features, self.lo,
                            self.hi)
        return y


class RowParallelLinear(_Shard):
    """A dense with its in features split: weight [out, hi − lo], the
    bias whole, added once after the partial products are all-reduced
    (in f32 under F16, then cast back)."""

    def __init__(self, full: nn.Linear, group, index: int, parts: int):
        super().__init__(group, index, parts)
        self.in_features, self.out_features = full.in_features, \
            full.out_features
        self.lo, self.hi = self.bounds(self.in_features)
        self.weight = nn.Parameter(full.weight.detach()[:, self.lo:self.hi]
                                   .clone())
        self.bias = nn.Parameter(full.bias.detach().clone())

    def forward(self, x):
        y = _linear(x, self.weight)
        y = reduce_from(y.float(), self.group).to(x.dtype)
        return y + self.bias.to(x.dtype)


class GatherFeatures(_Shard):
    """The whole last axis (`n` features) of a column-parallel shard."""

    def __init__(self, n: int, group, index: int, parts: int):
        super().__init__(group, index, parts)
        self.n = n

    def forward(self, x):
        return gather_from(x, self.group, self.n, *self.bounds(self.n))


def _slice_bn(bn: FrozenBN, lo: int, hi: int) -> FrozenBN:
    """A head batch norm over features [lo, hi) of `bn`'s."""
    out = FrozenBN(hi - lo, bn.train_bn)
    with torch.no_grad():
        for name in ('weight', 'bias', 'running_mean', 'running_var'):
            getattr(out, name).copy_(getattr(bn, name)[lo:hi])
    return out.to(bn.weight.device)


def shard_heads(model: nn.Module, mesh) -> None:
    """Split every head of `model` over the mesh's 'model' axis in place,
    keeping this rank's shards (the layers keep their names, so the
    state_dict's keys stay the whole model's)."""
    group, index = mesh.group(AXIS_MODEL), mesh.index(AXIS_MODEL)
    parts = mesh.shape[AXIS_MODEL]
    for head in model.modules():
        if not isinstance(head, _DenseStack):
            continue
        for i, layers in enumerate(head.dense):
            dense = head._modules[layers[0]]
            col = ColumnParallelLinear(dense, group, index, parts,
                                       gather_input=i > 0)
            head._modules[layers[0]] = col
            if len(layers) > 1:
                head._modules[layers[1]] = _slice_bn(
                    head._modules[layers[1]], col.lo, col.hi)
        for name in head.final_names:
            final = head._modules[name]
            head._modules[name] = (
                RowParallelLinear(final, group, index, parts) if head.dense
                else ColumnParallelLinear(final, group, index, parts,
                                          gather_output=True))
        if isinstance(head, KeypointHead) and head.dense:
            head.gather_hidden = GatherFeatures(head.out_features, group,
                                                index, parts)
