"""ResNet-18/34/50/101 backbones on [N,C,H,W] tensors, the counterpart
of `ursonet_tpu/models/resnet.py` (`FrozenAwareBN`, `BottleneckBlock`,
`BasicBlock`, `_remat_wrap`, `ResNetBackbone`, `ResNetShallowBackbone`,
`make_backbone`).

Module names are the reference's Keras layer names ('conv1', 'bn_conv1',
'res3a' > 'res3a_branch2a', 'bn3a_branch2a', ...; for ResNet-18/34
'conv0', 'bn_conv0', 'stage2_unit1' > 'stage2_unit1_conv1',
'stage2_unit1_bn2', ...), so a JAX parameter tree converts name for name
(`checkpoint/convert.py`).

Semantics kept from the JAX package:
  * Batch norm with Keras' epsilon 1e-3 and momentum 0.99 (`FrozenBN`,
    the counterpart of `FrozenAwareBN`). TRAIN_BN=False always
    normalizes with the running statistics and never updates them; the
    affine weight and bias still train. TRAIN_BN=None and True normalize
    with the batch's statistics in training (`module.train()`) and with
    the running ones in eval; the running update waits as the layer's
    `pending` statistics until the train step commits it
    (`commit_batch_stats`), once a step, after the backward pass.
  * Stem: explicit (3,3) zero pad, then a VALID 7×7/2 conv.
  * Flax 'SAME' at stride 2 pads (0,1) on even sizes, not (1,1): the
    3×3/2 maxpool gets that padding explicitly (with -inf), as does the
    3×3/2 bottleneck conv of `models/ursonet.py`.
  * Conv-block shortcuts and the '2a' convs are 1×1 with the block's
    stride, VALID.
  * The basic block (ResNet-18/34) keeps the reference's single batch
    norm: it follows conv1 and is named '<base>bn2'; conv2's output goes
    to the join raw. Its convs (3×3 with (1,1) pads, the 1×1/s 'sc'
    shortcut of a stage's first block) and the 'conv0' stem have no
    bias.
  * `stem_s2d` (STEM_SPACE_TO_DEPTH): the stem as its exact
    space-to-depth rewrite, a 4×4/1 conv with (2,1) pads over the 2×2
    packed input (`space_to_depth2`, `stem_kernel_to_s2d`).
  * bf16 compute (F16), as Flax's `dtype=bfloat16` runs op by op: the
    parameters stay f32 and are cast to bf16 where a bf16 input meets
    them (`Conv2d`, `Linear`: the product rounded to bf16, then the bf16
    bias added and rounded); batch norm normalizes in f32 with its f32
    statistics and returns bf16 (`FrozenBN`, as flax's `_normalize`).
    Under autograd the casts are differentiable, so the gradients of
    the f32 parameters come back in f32.
  * TRAIN_ACT_Q8 (`act_q8` True or 'wgrad8'): every backbone conv (the
    stem, the blocks' convs and their shortcuts) is a `ConvQ8`
    (`models/actq.py`), whose backward reads an int8 copy of its input;
    the forward and the parameters are the plain conv's.
  * REMAT: each residual block is one checkpoint
    (`torch.utils.checkpoint`, non-reentrant) under the JAX package's
    policies (`_remat_wrap`); outside autograd (eval, no_grad) blocks run
    plainly.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ursonet_torch.parallel.sharding import all_reduce_sum

# Keras BatchNormalization defaults
BN_EPS = 1e-3
BN_MOMENTUM = 0.99

# stage-4 identity blocks after res4a (`ursonet_tpu/models/resnet.py:311`)
STAGE4_BLOCKS = {'resnet50': 5, 'resnet101': 22}
# basic blocks per stage (`ursonet_tpu/models/resnet.py:341`)
SHALLOW_REPS = {'resnet18': (2, 2, 2, 2), 'resnet34': (3, 4, 6, 3)}


def check_remat(remat):
    """The REMAT policy (false: none), or ValueError for an unknown one."""
    if remat and remat not in (True, 'all', 'narrow', 'dots'):
        raise ValueError(f'unknown REMAT policy {remat!r}')
    return remat


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


def space_to_depth2(x: torch.Tensor) -> torch.Tensor:
    """[B,H,W,C] -> [B,H/2,W/2,4C] (NHWC), output channel
    (dy·2+dx)·C + c holding pixel (2i+dy, 2j+dx): the packing the s2d
    stem kernel of `stem_kernel_to_s2d` is laid out for. H and W even."""
    b, h, w, c = x.shape
    if h % 2 or w % 2:
        raise ValueError(f"space_to_depth2 needs even H and W, got {h}x{w}")
    x = x.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h // 2, w // 2, 4 * c)


def _space_to_depth2_nchw(x: torch.Tensor) -> torch.Tensor:
    """space_to_depth2 on [B,C,H,W]: the same channel order."""
    b, c, h, w = x.shape
    x = x.reshape(b, c, h // 2, 2, w // 2, 2).permute(0, 3, 5, 1, 2, 4)
    return x.reshape(b, 4 * c, h // 2, w // 2)


def stem_kernel_to_s2d(kernel) -> np.ndarray:
    """Exactly rewrite a (7,7,C,O) stride-2 stem kernel (HWIO, numpy) as
    the equivalent (4,4,4C,O) stride-1 kernel on space_to_depth2 input
    with padding [(2,1),(2,1)]: W'[R,S,(dy·2+dx)·C+c,o] =
    W[2R+dy−1, 2S+dx−1, c, o], zero where the source index falls outside
    [0,7)."""
    kernel = np.asarray(kernel)
    kh, kw, c, o = kernel.shape
    if (kh, kw) != (7, 7):
        raise ValueError(f"a 7x7 stem kernel, got {kh}x{kw}")
    out = np.zeros((4, 4, 4 * c, o), kernel.dtype)
    for r in range(4):
        for s in range(4):
            for dy in range(2):
                for dx in range(2):
                    u, v = 2 * r + dy - 1, 2 * s + dx - 1
                    if 0 <= u < 7 and 0 <= v < 7:
                        p = dy * 2 + dx
                        out[r, s, p * c:(p + 1) * c] = kernel[u, v]
    return out


class Conv2d(nn.Conv2d):
    """nn.Conv2d that computes in its input's dtype: a bf16 input meets
    the f32 weight and bias cast to bf16, the bias added after the bf16
    product (Flax's Conv with dtype=bfloat16)."""

    def forward(self, x):
        if x.dtype == self.weight.dtype:
            return super().forward(x)
        y = self._conv_forward(x, self.weight.to(x.dtype), None)
        if self.bias is None:
            return y
        return y + self.bias.to(x.dtype)[:, None, None]


def _conv(in_ch, out_ch, kernel, stride=1, padding=0, bias=True,
          act_q8=False) -> Conv2d:
    """A backbone conv: Conv2d, or under TRAIN_ACT_Q8 (`act_q8` True or
    'wgrad8') its int8 saved-activation form ConvQ8."""
    if act_q8:
        from ursonet_torch.models.actq import ConvQ8
        return ConvQ8(in_ch, out_ch, kernel, stride, padding=padding,
                      bias=bias, mode=act_q8)
    return Conv2d(in_ch, out_ch, kernel, stride, padding=padding, bias=bias)


class Linear(nn.Linear):
    """nn.Linear that computes in its input's dtype, as Conv2d."""

    def forward(self, x):
        if x.dtype == self.weight.dtype:
            return super().forward(x)
        return F.linear(x, self.weight.to(x.dtype)) + self.bias.to(x.dtype)


class FrozenBN(nn.Module):
    """Batch norm under the reference's TRAIN_BN semantics, the
    counterpart of the JAX package's `FrozenAwareBN` (Flax
    `nn.BatchNorm`):

      False  running statistics always, never updated (frozen);
      None   batch statistics in training, running statistics in eval;
      True   as None (the reference also puts a BN after every hidden
             head dense then, `models/heads.py`).

    The affine weight and bias are parameters, the running mean and
    variance buffers. A bf16 input is normalized in f32 and comes back as
    bf16 (mixed-type batch norm), as flax's `_normalize` does under
    dtype=bfloat16.

    In training with batch statistics the output is F.batch_norm's over
    the batch (its gradient runs through the statistics), and the
    statistics Flax's `_compute_stats` computes are kept, without
    gradient, as `pending` = (mean, var): reduced in f32, the biased
    E[x²] − E[x]² clipped at 0. They reach the running statistics only
    through `commit`: F.batch_norm's own update would use the unbiased
    variance, and a block recomputed under REMAT (torch.utils.checkpoint)
    would update twice, where a recompute only rewrites `pending` with
    the same values. At one value per channel (a head BN at batch 1)
    F.batch_norm refuses; Flax's formula gives the bias there, and runs
    as written.

    Over a mesh whose 'data' axis splits (`data_group`, set by
    `parallel/sharding.py::shard_model`) the batch statistics are the
    global batch's, as the JAX package computes them over the sharded
    batch: the per-channel sums are all-reduced over 'data' under
    autograd (the gradient runs through the global statistics), the
    variance in two passes as F.batch_norm's, and `pending` from the
    same global sums by Flax's fast formula. A rank never normalizes
    with its own rows' statistics there, and the one-value-per-channel
    case is the global batch's."""

    def __init__(self, num_features: int, train_bn=False):
        super().__init__()
        if train_bn not in (False, None, True):
            raise ValueError(f"TRAIN_BN must be False, None or True, got "
                             f"{train_bn!r}")
        self.train_bn = train_bn
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.pending = None
        self.data_group = None
        self.data_size = 1

    def forward(self, x):
        if self.train_bn is False or not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, training=False,
                                momentum=0.0, eps=BN_EPS)
        dims = [0] + list(range(2, x.dim()))
        if self.data_group is not None:
            return self._global_forward(x, dims)
        if x.numel() == x.shape[1]:
            # one value per channel: (x - mean) is 0, the output the bias
            xf = x.float()
            mean, var = _fast_stats(xf, dims)
            self.pending = (mean.detach(), var.detach())
            shape = [1, -1] + [1] * (x.dim() - 2)
            mul = torch.rsqrt(var + BN_EPS) * self.weight
            y = (xf - mean.view(shape)) * mul.view(shape) \
                + self.bias.view(shape)
            return y.to(x.dtype)
        with torch.no_grad():
            self.pending = _fast_stats(x.float(), dims)
        return F.batch_norm(x, None, None, self.weight, self.bias,
                            training=True, eps=BN_EPS)

    def _global_forward(self, x, dims):
        """Batch statistics over the global batch (every data rank holds
        as many rows, so it holds more than one value a channel)."""
        xf = x.float()
        n = (x.numel() // x.shape[1]) * self.data_size
        shape = [1, -1] + [1] * (x.dim() - 2)
        sums = all_reduce_sum(torch.stack(
            [xf.sum(dims), torch.square(xf.detach()).sum(dims)]),
            self.data_group)
        mean = sums[0] / n
        with torch.no_grad():
            self.pending = (mean.detach(), torch.clamp(
                sums[1] / n - torch.square(mean.detach()), min=0.0))
        d = xf - mean.view(shape)
        var = all_reduce_sum(torch.square(d).sum(dims), self.data_group) / n
        mul = torch.rsqrt(var + BN_EPS) * self.weight
        return (d * mul.view(shape) + self.bias.view(shape)).to(x.dtype)

    @torch.no_grad()
    def commit(self) -> bool:
        """Fold `pending` into the running statistics, r <- 0.99·r +
        (1 − 0.99)·s as Flax updates batch_stats, and clear it. False when
        nothing was pending."""
        if self.pending is None:
            return False
        mean, var = self.pending
        self.running_mean.copy_(self.running_mean * BN_MOMENTUM
                                + mean * (1 - BN_MOMENTUM))
        self.running_var.copy_(self.running_var * BN_MOMENTUM
                               + var * (1 - BN_MOMENTUM))
        self.pending = None
        return True


def _fast_stats(x, dims):
    """Flax's fast batch statistics of f32 `x` over `dims`: the mean and
    max(E[x²] − E[x]², 0), the biased variance."""
    mean = x.mean(dims)
    var = torch.clamp(torch.square(x).mean(dims) - torch.square(mean),
                      min=0.0)
    return mean, var


def commit_batch_stats(model: nn.Module) -> int:
    """Commit every batch norm's pending statistics once (`FrozenBN.
    commit`), the running update of one train step; returns how many
    layers it updated."""
    return sum(m.commit() for m in model.modules()
               if isinstance(m, FrozenBN))


class BottleneckBlock(nn.Module):
    """Bottleneck residual block: identity block, or conv block when
    `conv_shortcut` (a 1×1/s conv + BN on the shortcut).

    `remat` (config.REMAT) makes the block a checkpoint under autograd:
    True, 'all' and 'dots' recompute all of it in the backward pass;
    'narrow' runs the narrow part (2a, 2b and their BN and ReLU) outside
    the checkpoint and recomputes only the rest: the 1×1 expansion, its
    BN, the shortcut and the join. The 3×3 conv is never recomputed under
    'narrow'. Autograd then keeps four f1-wide tensors of the narrow part:
    the two ReLU outputs (the JAX policy's `res_narrow1`/`res_narrow2`)
    and the 2a and 2b conv outputs, which the BN affine gradients read.
    The JAX policy saves only the two ReLU outputs."""

    def __init__(self, in_ch: int, filters, stage: int, block: str,
                 strides: int = 1, conv_shortcut: bool = False,
                 train_bn=False, remat=False, act_q8=False):
        super().__init__()
        self.remat = check_remat(remat)
        f1, f2, f3 = filters
        self.cname = f"res{stage}{block}_branch"
        self.bname = f"bn{stage}{block}_branch"
        c, b = self.cname, self.bname
        aq = act_q8
        self.add_module(c + '2a', _conv(in_ch, f1, 1, strides, act_q8=aq))
        self.add_module(b + '2a', FrozenBN(f1, train_bn))
        self.add_module(c + '2b', _conv(f1, f2, 3, 1, padding=1, act_q8=aq))
        self.add_module(b + '2b', FrozenBN(f2, train_bn))
        self.add_module(c + '2c', _conv(f2, f3, 1, 1, act_q8=aq))
        self.add_module(b + '2c', FrozenBN(f3, train_bn))
        self.conv_shortcut = conv_shortcut
        if conv_shortcut:
            self.add_module(c + '1', _conv(in_ch, f3, 1, strides, act_q8=aq))
            self.add_module(b + '1', FrozenBN(f3, train_bn))

    def _narrow(self, x):
        m = self._modules
        c, b = self.cname, self.bname
        y = F.relu(m[b + '2a'](m[c + '2a'](x)), inplace=True)
        return F.relu(m[b + '2b'](m[c + '2b'](y)), inplace=True)

    def _expand(self, y, x):
        m = self._modules
        c, b = self.cname, self.bname
        y = m[b + '2c'](m[c + '2c'](y))
        sc = m[b + '1'](m[c + '1'](x)) if self.conv_shortcut else x
        return F.relu(y + sc, inplace=True)

    def _block(self, x):
        return self._expand(self._narrow(x), x)

    def forward(self, x):
        if not (self.remat and torch.is_grad_enabled()):
            return self._block(x)
        if self.remat == 'narrow':
            return checkpoint(self._expand, self._narrow(x), x,
                              use_reentrant=False)
        return checkpoint(self._block, x, use_reentrant=False)


class BasicBlock(nn.Module):
    """Basic residual block of ResNet-18/34 (the reference's single-BN
    structure): conv1 (3×3/s) -> '<base>bn2' -> ReLU -> conv2 (3×3/1),
    joined raw with the shortcut (a 1×1/s conv 'sc' for cut 'post', the
    input for 'pre'), then ReLU.

    `remat` (config.REMAT) makes the whole block one checkpoint under
    autograd for every policy: the JAX policies differ only by what they
    save inside a bottleneck block ('narrow' names the bottleneck's
    narrow activations, which a basic block does not have)."""

    def __init__(self, in_ch: int, filters: int, stage: int, block: int,
                 strides: int = 1, cut: str = 'pre', train_bn=False,
                 remat=False, act_q8=False):
        super().__init__()
        self.remat = check_remat(remat)
        self.base = f"stage{stage + 1}_unit{block + 1}_"
        b, aq = self.base, act_q8
        self.cut = cut
        if cut == 'post':
            self.add_module(b + 'sc', _conv(in_ch, filters, 1, strides,
                                            bias=False, act_q8=aq))
        self.add_module(b + 'conv1', _conv(in_ch, filters, 3, strides,
                                           padding=1, bias=False, act_q8=aq))
        self.add_module(b + 'bn2', FrozenBN(filters, train_bn))
        self.add_module(b + 'conv2', _conv(filters, filters, 3, 1,
                                           padding=1, bias=False, act_q8=aq))

    def _block(self, x):
        m, b = self._modules, self.base
        sc = m[b + 'sc'](x) if self.cut == 'post' else x
        y = F.relu(m[b + 'bn2'](m[b + 'conv1'](x)), inplace=True)
        return F.relu(m[b + 'conv2'](y) + sc, inplace=True)

    def forward(self, x):
        if not (self.remat and torch.is_grad_enabled()):
            return self._block(x)
        return checkpoint(self._block, x, use_reentrant=False)


class _Backbone(nn.Module):
    """The stem (`<stem>` conv, 'bn_<stem>', ReLU, the 3×3/2 maxpool with
    Flax's SAME pads) and the residual blocks in `blocks`, in order."""

    stem = 'conv1'

    def forward(self, x):
        if self.stem_s2d:
            x = F.pad(_space_to_depth2_nchw(x), (2, 1, 2, 1))
        conv, bn = self._modules[self.stem], self._modules['bn_' + self.stem]
        y = F.relu(bn(conv(x)), inplace=True)
        y = F.max_pool2d(pad_same(y, 3, 2, float('-inf')), 3, 2)
        for name in self.blocks:
            y = self._modules[name](y)
        return y

    def set_remat(self, remat) -> None:
        """Switch every residual block to the REMAT policy `remat`."""
        check_remat(remat)
        for name in self.blocks:
            self._modules[name].remat = remat


class ResNetBackbone(_Backbone):
    """ResNet-50/101 feature extractor; returns C5 [N,2048,H/32,W/32].
    ResNet-101 differs only in stage 4: res4a, then 22 identity blocks
    res4b ... res4w.

    `inner_mult` (INNER_WIDTH_MULT) scales each bottleneck's inner widths
    (f1, f2) by `scale_inner`: the reduced-FLOP serving variant. Stream
    widths and layer names stay, so a flagship checkpoint prunes into it
    by channel selection (`ursonet_torch/prune_inner.py`)."""

    def __init__(self, architecture: str = 'resnet50', train_bn=False,
                 stem_s2d: bool = False, remat=False,
                 inner_mult: float = 1.0, act_q8=False):
        super().__init__()
        if architecture not in STAGE4_BLOCKS:
            raise ValueError(f"unsupported backbone {architecture}")
        self.stem_s2d = stem_s2d
        self.conv1 = _conv(12, 64, 4, 1, act_q8=act_q8) if stem_s2d \
            else _conv(3, 64, 7, 2, padding=3, act_q8=act_q8)
        self.bn_conv1 = FrozenBN(64, train_bn)
        self.blocks = []
        in_ch = 64

        def blk(filters, stage, block, strides=1, conv_shortcut=False):
            nonlocal in_ch
            name = f'res{stage}{block}'
            f1, f2, f3 = filters
            filters = (scale_inner(f1, inner_mult),
                       scale_inner(f2, inner_mult), f3)
            self.add_module(name, BottleneckBlock(
                in_ch, filters, stage, block, strides, conv_shortcut,
                train_bn, remat, act_q8))
            self.blocks.append(name)
            in_ch = filters[2]

        blk((64, 64, 256), 2, 'a', 1, True)
        blk((64, 64, 256), 2, 'b')
        blk((64, 64, 256), 2, 'c')
        blk((128, 128, 512), 3, 'a', 2, True)
        for b in 'bcd':
            blk((128, 128, 512), 3, b)
        blk((256, 256, 1024), 4, 'a', 2, True)
        for i in range(STAGE4_BLOCKS[architecture]):
            blk((256, 256, 1024), 4, chr(98 + i))
        blk((512, 512, 2048), 5, 'a', 2, True)
        blk((512, 512, 2048), 5, 'b')
        blk((512, 512, 2048), 5, 'c')


class ResNetShallowBackbone(_Backbone):
    """ResNet-18/34 feature extractor; returns C5 [N,512,H/32,W/32]: the
    'conv0' stem (7×7/2, or its s2d form, no bias), 'bn_conv0', ReLU, the
    3×3/2 maxpool, then four stages of basic blocks 'stage{S}_unit{U}'
    (64·2^stage wide; a stage's first block has the 1×1 'sc' shortcut,
    stride 2 from the second stage on)."""

    stem = 'conv0'

    def __init__(self, architecture: str = 'resnet18', train_bn=False,
                 stem_s2d: bool = False, remat=False, act_q8=False):
        super().__init__()
        if architecture not in SHALLOW_REPS:
            raise ValueError(f"unsupported backbone {architecture}")
        self.stem_s2d = stem_s2d
        self.conv0 = _conv(12, 64, 4, 1, bias=False, act_q8=act_q8) \
            if stem_s2d else _conv(3, 64, 7, 2, padding=3, bias=False,
                                   act_q8=act_q8)
        self.bn_conv0 = FrozenBN(64, train_bn)
        self.blocks = []
        in_ch = 64
        for stage, reps in enumerate(SHALLOW_REPS[architecture]):
            filters = 64 * 2 ** stage
            for block in range(reps):
                strides = 2 if block == 0 and stage > 0 else 1
                name = f'stage{stage + 1}_unit{block + 1}'
                self.add_module(name, BasicBlock(
                    in_ch, filters, stage, block, strides,
                    'post' if block == 0 else 'pre', train_bn, remat,
                    act_q8))
                self.blocks.append(name)
                in_ch = filters


# C5 channels of each backbone
C5_CHANNELS = {'resnet18': 512, 'resnet34': 512, 'resnet50': 2048,
               'resnet101': 2048}


def scale_inner(f: int, mult: float) -> int:
    """Scaled inner width, rounded to a multiple of 8 (min 8)."""
    return max(8, int(round(f * mult / 8.0)) * 8)


def make_backbone(architecture: str, train_bn=False, stem_s2d: bool = False,
                  remat=False, inner_mult: float = 1.0,
                  act_q8=False) -> nn.Module:
    """The backbone of `architecture` (resnet18/34/50/101), as the JAX
    package's `make_backbone` dispatches. `inner_mult`
    (INNER_WIDTH_MULT) scales a bottleneck's inner widths; a basic block
    has none, so anything but 1 raises for ResNet-18/34. `act_q8`
    (TRAIN_ACT_Q8) makes every backbone conv a ConvQ8. 'hrnet_w32' is
    the landmark-heatmap backbone (`models/hrnet.py`), which takes
    neither the s2d stem, nor inner widths, nor TRAIN_ACT_Q8."""
    from ursonet_torch.models import hrnet
    if hrnet.is_hrnet(architecture):
        if stem_s2d or inner_mult != 1.0 or act_q8:
            raise ValueError(f'{architecture} takes no '
                             'STEM_SPACE_TO_DEPTH, INNER_WIDTH_MULT or '
                             'TRAIN_ACT_Q8')
        return hrnet.HRNetBackbone(architecture, train_bn, remat)
    if architecture in STAGE4_BLOCKS:
        return ResNetBackbone(architecture, train_bn, stem_s2d, remat,
                              inner_mult, act_q8)
    if architecture in SHALLOW_REPS:
        if inner_mult != 1.0:
            raise ValueError('INNER_WIDTH_MULT applies to bottleneck '
                             'backbones (resnet50/101) only: basic blocks '
                             'have no inner channel space distinct from '
                             'the residual stream')
        return ResNetShallowBackbone(architecture, train_bn, stem_s2d, remat,
                                     act_q8)
    raise ValueError(f"unsupported backbone {architecture}")
