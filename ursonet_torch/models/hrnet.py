"""HRNet-W32, the landmark-heatmap backbone (Sun, Xiao, Liu and Wang,
CVPR 2019, arXiv:1902.09212; `PoseHighResolutionNet` of
github.com/leoxiaobin/deep-high-resolution-net.pytorch, config
`experiments/coco/hrnet/w32_256x192_adam_lr1e-3.yaml`), the network of
the ESA pose challenge's winner (Chen, Cao, Parra and Chin,
arXiv:1908.11542), on [N,C,H,W] tensors. Every conv is bias-free and
followed by batch norm; H and W are multiples of 32.

  stem     3×3/2 conv 3→64, BN, ReLU; 3×3/2 conv 64→64, BN, ReLU (¼
           resolution), then stage 1: 4 bottlenecks of width 64 and output
           256 (1×1, 3×3, 1×1, each with BN; the first with a 1×1
           projection shortcut; the stride, 1 here, would sit on the 3×3)
  stages   2, 3, 4: 1, 4 and 3 modules of 2, 3 and 4 parallel branches of
           widths 32, 64, 128, 256 at ¼, ⅛, 1/16, 1/32 resolution. A
           module runs 4 basic blocks a branch (3×3, BN, ReLU, 3×3, BN,
           + identity, ReLU), then fuses: output branch i is
           ReLU(Σ_j f_ij(x_j)), f_ii the identity, f_ij for j > i a 1×1
           conv C_j→C_i with BN then nearest upsampling ×2^(j−i), for
           j < i a chain of i−j 3×3/2 convs with BN, the links C_j wide
           with ReLU, the last to C_i without. The last module of stage
           4 fuses into branch 0 only.
  transitions  into stage 2: 3×3/1 conv 256→32 and 3×3/2 conv 256→64, each
           with BN and ReLU; into stages 3 and 4 the old branches pass
           as they are and the new one is a 3×3/2 conv with BN and ReLU
           from the last branch.

The backbone returns branch 0 [N,32,H/4,W/4]; the head (`models/heads.py::
HeatmapHead`, a 1×1 conv 32→K with bias) turns it into K heatmaps.

Module names follow the HRNet repository's where they can (`conv1`,
`bn1`, `layer1.0.conv2`, `stage3.2.branches.1.3.bn2`, `transition2.2`,
`stage4.0.fuse_layers.3.0.1`) with two changes that keep a batch norm's
name starting with 'bn', as the port's weight layout reads it
(`checkpoint/convert.py::is_bn_layer`): a conv with its batch norm is a
`ConvBN` with children `conv` and `bn`, and a bottleneck's projection
shortcut is `downsample` (a `ConvBN`).

Departures from the HRNet repository, which the configuration's
`changed` repeats: batch norm as the port's `FrozenBN` (Keras' ε 1e-3
and momentum 0.99 where HRNet has PyTorch's 1e-5 and 0.1, and Flax's
fast biased variance E[x²] − E[x]² for the running update where PyTorch
takes the unbiased one), and the port's train step (AMSGrad after
optax for HRNet's Adam, the port's L2 term Σ wd·mean(w²) for Adam's
coupled weight decay, the global-norm clip at GRADIENT_CLIP_NORM).
Under F16 the convs compute in bf16 and the batch norms normalize in
f32, as in the ResNets (`models/resnet.py`).

REMAT makes each basic block and each bottleneck one non-reentrant
checkpoint under autograd, as `BasicBlock` does; the fusions and
transitions are not recomputed.

Spans (`utils/profiling.py`): ursonet.hrnet.stem (the stem convs),
ursonet.hrnet.stage1 (the bottlenecks), ursonet.hrnet.branch (a
module's basic blocks), ursonet.hrnet.fuse (its fusion); the head's
ursonet.hrnet.head is the caller's (`models/ursonet.py`). The landmark
counter (`ops/landmarks.py::counts`) takes the modules run and the
fusion sums they made (a recompute under REMAT counts no module: the
fusions are outside the checkpoints).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ursonet_torch.models.resnet import Conv2d, FrozenBN, check_remat
from ursonet_torch.ops import landmarks as lm
from ursonet_torch.utils.profiling import span

# the published widths: branch channels, and per stage (modules,
# branches); every branch of every module runs 4 basic blocks
HRNET_WIDTHS = {'hrnet_w32': 32}
STAGES = ((1, 2), (4, 3), (3, 4))
BLOCKS = 4
STAGE1_BLOCKS = 4
STEM_WIDTH = 64
def is_hrnet(architecture: str) -> bool:
    return architecture in HRNET_WIDTHS


def branch_widths(architecture: str) -> tuple:
    """The four branches' channels: C, 2C, 4C, 8C."""
    c = HRNET_WIDTHS[architecture]
    return tuple(c << i for i in range(4))


class ConvBN(nn.Module):
    """conv (bias-free, k×k/s, padding k // 2) -> bn [-> ReLU]."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1,
                 relu: bool = True, train_bn=False):
        super().__init__()
        self.conv = Conv2d(in_ch, out_ch, kernel, stride,
                           padding=kernel // 2, bias=False)
        self.bn = FrozenBN(out_ch, train_bn)
        self.relu = relu

    def forward(self, x):
        y = self.bn(self.conv(x))
        return F.relu(y, inplace=True) if self.relu else y


def _checkpointed(block, x):
    if block.remat and torch.is_grad_enabled():
        return checkpoint(block._block, x, use_reentrant=False)
    return block._block(x)


class Bottleneck(nn.Module):
    """Stage 1's bottleneck, torchvision-style: conv1 1×1 -> bn1 -> ReLU ->
    conv2 3×3/s -> bn2 -> ReLU -> conv3 1×1 (4× wide) -> bn3, plus the
    input or its `downsample` (1×1/s conv and BN), then ReLU."""

    def __init__(self, in_ch: int, planes: int, stride: int = 1,
                 train_bn=False, remat=False):
        super().__init__()
        self.remat = check_remat(remat)
        out_ch = 4 * planes
        self.conv1 = Conv2d(in_ch, planes, 1, bias=False)
        self.bn1 = FrozenBN(planes, train_bn)
        self.conv2 = Conv2d(planes, planes, 3, stride, padding=1, bias=False)
        self.bn2 = FrozenBN(planes, train_bn)
        self.conv3 = Conv2d(planes, out_ch, 1, bias=False)
        self.bn3 = FrozenBN(out_ch, train_bn)
        self.downsample = ConvBN(in_ch, out_ch, 1, stride, relu=False,
                                 train_bn=train_bn) \
            if stride != 1 or in_ch != out_ch else None

    def _block(self, x):
        y = F.relu(self.bn1(self.conv1(x)), inplace=True)
        y = F.relu(self.bn2(self.conv2(y)), inplace=True)
        y = self.bn3(self.conv3(y))
        sc = x if self.downsample is None else self.downsample(x)
        return F.relu(y + sc, inplace=True)

    def forward(self, x):
        return _checkpointed(self, x)


class HRBasicBlock(nn.Module):
    """HRNet's basic block: conv1 3×3 -> bn1 -> ReLU -> conv2 3×3 -> bn2,
    plus the identity, then ReLU (the port's ResNet-18/34 `BasicBlock`
    keeps the reference's single batch norm instead)."""

    def __init__(self, channels: int, train_bn=False, remat=False):
        super().__init__()
        self.remat = check_remat(remat)
        self.conv1 = Conv2d(channels, channels, 3, padding=1, bias=False)
        self.bn1 = FrozenBN(channels, train_bn)
        self.conv2 = Conv2d(channels, channels, 3, padding=1, bias=False)
        self.bn2 = FrozenBN(channels, train_bn)

    def _block(self, x):
        y = F.relu(self.bn1(self.conv1(x)), inplace=True)
        return F.relu(self.bn2(self.conv2(y)) + x, inplace=True)

    def forward(self, x):
        return _checkpointed(self, x)


class HRModule(nn.Module):
    """One module of parallel branches (`branches[i]`: BLOCKS basic
    blocks of widths[i]) and its fusion (`fuse_layers[i][j]`, None where
    i == j), into every branch or, without `multi_scale_output`, into
    branch 0 alone."""

    def __init__(self, widths, multi_scale_output: bool = True,
                 train_bn=False, remat=False):
        super().__init__()
        n = len(widths)
        self.branches = nn.ModuleList(
            nn.Sequential(*[HRBasicBlock(c, train_bn, remat)
                            for _ in range(BLOCKS)]) for c in widths)
        fuse = []
        for i in range(n if multi_scale_output else 1):
            row = []
            for j in range(n):
                if j > i:
                    row.append(ConvBN(widths[j], widths[i], 1, relu=False,
                                      train_bn=train_bn))
                elif j == i:
                    row.append(None)
                else:
                    row.append(nn.Sequential(*[
                        ConvBN(widths[j], widths[i] if k == i - j - 1
                               else widths[j], 3, 2, relu=k < i - j - 1,
                               train_bn=train_bn)
                        for k in range(i - j)]))
            fuse.append(nn.ModuleList(row))
        self.fuse_layers = nn.ModuleList(fuse)

    def forward(self, xs):
        with span('ursonet.hrnet.branch'):
            xs = [b(x) for b, x in zip(self.branches, xs)]
        with span('ursonet.hrnet.fuse'):
            out = []
            for i, row in enumerate(self.fuse_layers):
                # HRNet's order: branch 0's term first, then j = 1, 2, ...
                y = xs[0] if i == 0 else row[0](xs[0])
                for j in range(1, len(xs)):
                    if j == i:
                        y = y + xs[j]
                    elif j > i:
                        y = y + F.interpolate(row[j](xs[j]),
                                              scale_factor=2 ** (j - i),
                                              mode='nearest')
                    else:
                        y = y + row[j](xs[j])
                out.append(F.relu(y))
        lm.count(modules=1, fusion_sums=len(out) * (len(xs) - 1))
        return out


class HRNetBackbone(nn.Module):
    """HRNet-W32 (module docstring): images [N,3,H,W] -> branch 0
    [N,32,H/4,W/4]."""

    def __init__(self, architecture: str = 'hrnet_w32', train_bn=False,
                 remat=False):
        super().__init__()
        widths = branch_widths(architecture)
        self.out_channels = widths[0]
        self.conv1 = Conv2d(3, STEM_WIDTH, 3, 2, padding=1, bias=False)
        self.bn1 = FrozenBN(STEM_WIDTH, train_bn)
        self.conv2 = Conv2d(STEM_WIDTH, STEM_WIDTH, 3, 2, padding=1,
                            bias=False)
        self.bn2 = FrozenBN(STEM_WIDTH, train_bn)
        self.layer1 = nn.Sequential(*[
            Bottleneck(STEM_WIDTH if b == 0 else 4 * STEM_WIDTH, STEM_WIDTH,
                       train_bn=train_bn, remat=remat)
            for b in range(STAGE1_BLOCKS)])
        self.transition1 = nn.ModuleList([
            ConvBN(4 * STEM_WIDTH, widths[0], 3, 1, train_bn=train_bn),
            ConvBN(4 * STEM_WIDTH, widths[1], 3, 2, train_bn=train_bn)])
        for s, (modules, n) in enumerate(STAGES):
            if s:
                # the old branches pass; the new one from the last branch
                self.add_module(f'transition{s + 1}', nn.ModuleList(
                    [nn.Identity() for _ in range(n - 1)]
                    + [ConvBN(widths[n - 2], widths[n - 1], 3, 2,
                              train_bn=train_bn)]))
            last = s == len(STAGES) - 1
            self.add_module(f'stage{s + 2}', nn.Sequential(*[
                HRModule(widths[:n], not (last and m == modules - 1),
                         train_bn, remat) for m in range(modules)]))

    def forward(self, x):
        with span('ursonet.hrnet.stem'):
            x = F.relu(self.bn1(self.conv1(x)), inplace=True)
            x = F.relu(self.bn2(self.conv2(x)), inplace=True)
        with span('ursonet.hrnet.stage1'):
            x = self.layer1(x)
        xs = [t(x) for t in self.transition1]
        for s in range(len(STAGES)):
            if s:
                trans = self._modules[f'transition{s + 1}']
                xs = xs + [trans[-1](xs[-1])]
            for module in self._modules[f'stage{s + 2}']:
                xs = module(xs)
        return xs[0]
