"""The full UrsoNet model, the counterpart of
`ursonet_tpu/models/ursonet.py` (`UrsoNetModule`, `build_model`):
backbone C5 → stride-2 3×3 bottleneck conv ('bottleneck_layer', Flax
'SAME' padding) → NHWC row-major flatten → location and orientation
heads, or in keypoint mode (REGRESS_KEYPOINTS) the keypoint head alone,
under the module name 'loc_head'. Returns a dict of raw head outputs, in
f32: {'loc', 'ori'}, or {'loc': k1, 'k1': k2, 'k2': k3} in keypoint mode
(the JAX package's names, shifted by one on purpose).

Under F16 (`dtype` bfloat16) the forward computes in bf16 with f32
parameters, as the JAX package's `UrsoNetModule(dtype=bfloat16)`: the
images are cast to bf16 first, every conv and dense runs in bf16 (batch
norm in f32 on its statistics, `models/resnet.py`), and the head outputs
are widened to f32, under autograd too (the bf16 train step).
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
from torch import nn

from ursonet_torch.device import resolve_device
from ursonet_torch.models.heads import KeypointHead, PoseHead
from ursonet_torch.models.resnet import Conv2d, FrozenBN, ResNetBackbone, \
    pad_same
from ursonet_torch.train.state import add_loss_log_vars


def _c6_hw(h: int, w: int) -> tuple[int, int]:
    """Spatial size after the six stride-2 stages ('SAME'-style ceil)."""
    for _ in range(6):
        h, w = -(-h // 2), -(-w // 2)
    return h, w


class UrsoNetModule(nn.Module):
    """images [N,3,H,W] f32 -> {'loc', 'ori'} (or {'loc', 'k1', 'k2'})
    f32, computed in `dtype`."""

    def __init__(self, image_hw, backbone: str = 'resnet50',
                 bottleneck_width: int = 128, branch_size: int = 1024,
                 nr_dense_layers: int = 1, regress_loc: bool = True,
                 regress_ori: bool = True,
                 orientation_param: str = 'quaternion', loc_bins: int = 16,
                 ori_bins: int = 32, train_bn=False, stem_s2d: bool = False,
                 dtype: torch.dtype = torch.float32,
                 regress_keypoints: bool = False, remat=False):
        super().__init__()
        self.dtype = dtype
        self.regress_keypoints = regress_keypoints
        self.backbone = ResNetBackbone(backbone, train_bn, stem_s2d, remat)
        self.bottleneck_layer = Conv2d(2048, bottleneck_width, 3, 2)
        h6, w6 = _c6_hw(*image_hw)
        feats = bottleneck_width * h6 * w6
        if regress_keypoints:
            self.loc_head = KeypointHead(feats, nr_dense_layers, branch_size,
                                         train_bn)
            return
        if regress_loc:
            loc_feats, loc_act = 3, 'linear'
        else:
            loc_feats, loc_act = loc_bins ** 3, 'relu'
        self.loc_head = PoseHead('loc', feats, nr_dense_layers, branch_size,
                                 loc_feats, loc_act, 'loc_final', train_bn)
        if regress_ori:
            if orientation_param == 'quaternion':
                ori = (4, 'l2norm', 'ori_q')
            else:
                ori = (3, 'linear', 'ori_final')
        else:
            ori = (ori_bins ** 3, 'relu', 'ori_final')
        self.ori_head = PoseHead('ori', feats, nr_dense_layers, branch_size,
                                 *ori, train_bn)

    def forward(self, images) -> Dict[str, torch.Tensor]:
        c5 = self.backbone(images.to(self.dtype))
        c6 = self.bottleneck_layer(pad_same(c5, 3, 2))
        # NHWC row-major flatten, as the Keras Reshape the dense kernels
        # were laid out for
        feats = c6.permute(0, 2, 3, 1).reshape(c6.shape[0], -1)
        if self.regress_keypoints:
            k1, k2, k3 = self.loc_head(feats)
            return {'loc': k1.to(torch.float32), 'k1': k2.to(torch.float32),
                    'k2': k3.to(torch.float32)}
        return {'loc': self.loc_head(feats).to(torch.float32),
                'ori': self.ori_head(feats).to(torch.float32)}


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Flax's default initialization: conv and dense kernels LeCun
    truncated normal (fan-in), biases zero; BN weight 1, bias 0, running
    mean 0, variance 1. Draws only from `generator` (a CPU generator;
    the model must be on the CPU)."""
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            fan_in = m.weight[0].numel()
            # truncated at ±2σ; 0.8796... is the std of a unit normal
            # truncated there
            std = math.sqrt(1.0 / fan_in) / .87962566103423978
            nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
            nn.init.zeros_(m.bias)
        elif isinstance(m, FrozenBN):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
            m.running_mean.zero_()
            m.running_var.fill_(1.0)


def build_model(config, device="cuda",
                generator: Optional[torch.Generator] = None) -> UrsoNetModule:
    """Build the model for `config` on `device`, with weights drawn from
    `generator` (default: a CPU generator seeded with config.SEED),
    computing in bf16 under config.F16, its residual blocks recomputed in
    the backward pass under config.REMAT, with zero Kendall
    log-variances (`loss_log_vars`) under LEARNABLE_LOSS_WEIGHTS.
    Validates the %64 image-shape contract."""
    dev = resolve_device(device)
    h, w = int(config.IMAGE_SHAPE[0]), int(config.IMAGE_SHAPE[1])
    if h % 64 or w % 64:
        raise ValueError(
            "Image size must be dividable by 2 at least 6 times; got "
            f"{h}x{w}. Use 256, 320, 384, 448, 512, ...")
    with torch.device('meta'):
        model = UrsoNetModule(
            (h, w), backbone=config.BACKBONE,
            bottleneck_width=config.BOTTLENECK_WIDTH,
            branch_size=config.BRANCH_SIZE,
            nr_dense_layers=config.NR_DENSE_LAYERS,
            regress_loc=config.REGRESS_LOC, regress_ori=config.REGRESS_ORI,
            orientation_param=config.ORIENTATION_PARAM,
            loc_bins=config.LOC_BINS_PER_DIM, ori_bins=config.ORI_BINS_PER_DIM,
            train_bn=config.TRAIN_BN,
            stem_s2d=bool(getattr(config, 'STEM_SPACE_TO_DEPTH', False)),
            dtype=torch.bfloat16 if config.F16 else torch.float32,
            regress_keypoints=config.REGRESS_KEYPOINTS,
            remat=config.REMAT)
    model.to_empty(device='cpu')
    if generator is None:
        generator = torch.Generator().manual_seed(int(config.SEED))
    init_weights(model, generator)
    add_loss_log_vars(model, config)
    return model.to(dev)
