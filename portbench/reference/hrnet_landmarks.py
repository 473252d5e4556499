"""Plain reference of the landmark model's train step (HRNet-W32 heatmaps,
`configs/spec_hrnet_w32_landmarks.json`) on a device-resident dataset, in
plain PyTorch: float32 with TF32 off, no kernels of the program, nothing
imported from it.

One step, as the configuration states it: gather the batch's rows; draw
the rotation augmentation and apply it to the pose and, by nearest
sampling, to the image, then subtract the pixel mean (the recipe and the
order of draws of `train_step.py`); project the body-frame landmarks
with the crop's intrinsics and the augmented pose (camera point
R(q)·p + t); render HRNet's targets (`JointsDataset.generate_target`,
written out below as the HRNet repository has it, landmark by landmark
on the host); the forward of HRNet-W32 (stem, stage 1's bottlenecks,
the transitions, the modules of parallel basic-block branches and their
fusions; every conv bias-free and followed by batch norm over the
batch's statistics, ε 1e-3) and the 1x1 head; JointsMSE with the target
weights, ½·mean((w·(ŷ − y))²), plus WEIGHT_DECAY · Σ mean(w²) over the
weights outside batch norm; the gradient; the clip by global norm;
AMSGrad as optax has it (b1 0.9, b2 0.999, ε 1e-8; the running maximum
of the bias-corrected second moment); after the step the batch norms'
running statistics take 0.99·r + 0.01·s with the biased variance
E[x²] − E[x]² of the step's batch.

Parameters and statistics are keyed by the program's names
(`backbone.stage3.1.branches.2.0.conv1.weight`,
`backbone.transition1.1.conv.weight`, `heatmap_head.final_layer.bias`).

`checkpointed=True` runs every block, transition and fusion under
`torch.utils.checkpoint`, which recomputes the same arithmetic in the
backward pass, so that a float32 step at the cell's batch fits the card
(the batch statistics are kept from the last evaluation of each batch
norm, which the recompute repeats).

`precision='fp8'` is the control: every conv computes on its operands
rounded to float8 (per-tensor scales: e4m3 for activations and weights,
e5m2 for the gradients the backward products take), one precision below
the configuration's bf16.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from reference.train_step import BN_EPS, _fp8, _Grad8, draw_rotation, \
    euler_to_rot, is_bn, quat_mul, quat_to_rot, rot_to_quat, warp_mold

BN_MOMENTUM = 0.99
STAGES = ((1, 2), (4, 3), (3, 4))
STRIDE = 4


def speed_crop_k(size: int = 768, focal: float = 3003.4) -> np.ndarray:
    """SPEED's camera (f = 17.6 mm over 5.86 µm pixels) on a size² crop,
    its principal point at the crop's centre, no resize."""
    c = size / 2.0
    return np.array([[focal, 0, c], [0, focal, c], [0, 0, 1.0]])


# --------------------------------------------------------------------------
# augmentation and targets

def augment(raw: dict, gen: torch.Generator, rec: dict):
    """(images [B,3,H,W] f32 molded, location [B,3], quaternion [B,4])
    after the rotation augmentation; `rec`: rot_aug, rot_image_aug,
    k_net, mean."""
    locs = raw['location'].to(torch.float32)
    quats = raw['quaternion'].to(torch.float32)
    b = locs.shape[0]
    dice, pyr_cam, roll = draw_rotation(gen, b)
    use_cam = (dice > 0.5) & bool(rec['rot_aug'])
    use_roll = (dice <= 0.5) & bool(rec['rot_image_aug'])
    pyr_roll = torch.cat([torch.zeros_like(pyr_cam[:, :2]), roll], 1)
    pyr = torch.where(use_cam[:, None], pyr_cam,
                      torch.where(use_roll[:, None], pyr_roll,
                                  torch.zeros_like(pyr_cam)))
    r = euler_to_rot(pyr[:, 0], pyr[:, 1], pyr[:, 2])
    k = torch.as_tensor(rec['k_net'], dtype=torch.float32, device=locs.device)
    m = (k @ r @ torch.linalg.inv(k)).contiguous()
    identity = ~(use_cam | use_roll)
    locs2 = torch.where(identity[:, None], locs,
                        torch.einsum('bi,bji->bj', locs, r))
    quats2 = torch.where(identity[:, None], quats,
                         quat_mul(rot_to_quat(r), quats))
    images = warp_mold(raw['images_u8'], m, identity, rec['mean'])
    return images, locs2, quats2


def landmark_pixels(points, locs, quats, k_net):
    """(pixels [B,K,2], depths [B,K]) of body-frame points [K,3]."""
    rot = quat_to_rot(quats)                        # [B,3,3]
    cam = torch.stack([locs + rot @ p for p in points.unbind(0)],
                      1)                            # [B,K,3]
    k = torch.as_tensor(k_net, dtype=torch.float32, device=locs.device)
    x = k[0, 0] * cam[..., 0] / cam[..., 2] + k[0, 2]
    y = k[1, 1] * cam[..., 1] / cam[..., 2] + k[1, 2]
    return torch.stack([x, y], -1), cam[..., 2]


def generate_target(pixels: np.ndarray, depths: np.ndarray, heatmap_hw,
                    sigma: float):
    """HRNet's `JointsDataset.generate_target` for one image: pixels
    [K,2], depths [K] -> (target [K,h,w], weight [K]) float32; a landmark
    behind the camera gets weight 0 besides."""
    h, w = heatmap_hw
    k = pixels.shape[0]
    target = np.zeros((k, h, w), np.float32)
    weight = np.ones(k, np.float32)
    tmp_size = int(sigma * 3)
    for j in range(k):
        mu_x = int(pixels[j][0] / STRIDE + 0.5)
        mu_y = int(pixels[j][1] / STRIDE + 0.5)
        ul = [int(mu_x - tmp_size), int(mu_y - tmp_size)]
        br = [int(mu_x + tmp_size + 1), int(mu_y + tmp_size + 1)]
        if ul[0] >= w or ul[1] >= h or br[0] < 0 or br[1] < 0 \
                or depths[j] <= 0:
            weight[j] = 0
            continue
        size = 2 * tmp_size + 1
        x = np.arange(0, size, 1, np.float32)
        y = x[:, np.newaxis]
        x0 = y0 = size // 2
        g = np.exp(- ((x - x0) ** 2 + (y - y0) ** 2) / (2 * sigma ** 2))
        g_x = max(0, -ul[0]), min(br[0], w) - ul[0]
        g_y = max(0, -ul[1]), min(br[1], h) - ul[1]
        img_x = max(0, ul[0]), min(br[0], w)
        img_y = max(0, ul[1]), min(br[1], h)
        target[j][img_y[0]:img_y[1], img_x[0]:img_x[1]] = \
            g[g_y[0]:g_y[1], g_x[0]:g_x[1]]
    return target, weight


def targets(pixels, depths, heatmap_hw, sigma: float):
    """generate_target over a batch: (targets [B,K,h,w], weights [B,K])
    on the pixels' device."""
    px, dz = pixels.cpu().numpy(), depths.cpu().numpy()
    out = [generate_target(px[i], dz[i], heatmap_hw, sigma)
           for i in range(px.shape[0])]
    dev = pixels.device
    return (torch.from_numpy(np.stack([t for t, _ in out])).to(dev),
            torch.from_numpy(np.stack([w for _, w in out])).to(dev))


# --------------------------------------------------------------------------
# the model

class Model:
    """HRNet-W32 and its heatmap head over parameter and buffer dicts keyed
    by the program's names; batch statistics, kept in `stats`."""

    def __init__(self, params: Dict[str, torch.Tensor], precision: str,
                 checkpointed: bool):
        self.p = params
        self.fp8 = precision == 'fp8'
        self.checkpointed = checkpointed
        self.stats: Dict[str, tuple] = {}

    def conv(self, x, name, stride=1):
        wgt = self.p[name + '.weight']
        pad = wgt.shape[-1] // 2
        if self.fp8:
            x, wgt = _fp8(x), _fp8(wgt)
        y = F.conv2d(x, wgt, self.p.get(name + '.bias'), stride, pad)
        return _Grad8.apply(y) if self.fp8 else y

    def bn(self, x, name):
        with torch.no_grad():
            mean = x.mean((0, 2, 3))
            var = torch.clamp(torch.square(x).mean((0, 2, 3))
                              - torch.square(mean), min=0.0)
            self.stats[name] = (mean, var)
        return F.batch_norm(x, None, None, self.p[name + '.weight'],
                            self.p[name + '.bias'], training=True,
                            eps=BN_EPS)

    def conv_bn(self, x, name, stride=1, relu=True):
        y = self.bn(self.conv(x, name + '.conv', stride), name + '.bn')
        return F.relu(y) if relu else y

    def _run(self, fn, *args):
        if self.checkpointed and torch.is_grad_enabled():
            return checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    def bottleneck(self, x, p, shortcut):
        def f(x):
            y = F.relu(self.bn(self.conv(x, p + '.conv1'), p + '.bn1'))
            y = F.relu(self.bn(self.conv(y, p + '.conv2'), p + '.bn2'))
            y = self.bn(self.conv(y, p + '.conv3'), p + '.bn3')
            sc = self.conv_bn(x, p + '.downsample', relu=False) \
                if shortcut else x
            return F.relu(y + sc)
        return self._run(f, x)

    def basic(self, x, p):
        def f(x):
            y = F.relu(self.bn(self.conv(x, p + '.conv1'), p + '.bn1'))
            return F.relu(self.bn(self.conv(y, p + '.conv2'), p + '.bn2') + x)
        return self._run(f, x)

    def fuse(self, xs, p, n_out):
        def f(*xs):
            out = []
            for i in range(n_out):
                y = None
                for j, x in enumerate(xs):
                    q = f'{p}.fuse_layers.{i}.{j}'
                    if j == i:
                        t = x
                    elif j > i:
                        t = F.interpolate(self.conv_bn(x, q, relu=False),
                                          scale_factor=2 ** (j - i),
                                          mode='nearest')
                    else:
                        t = x
                        for k in range(i - j):
                            t = self.conv_bn(t, f'{q}.{k}', 2,
                                             relu=k < i - j - 1)
                    y = t if y is None else y + t
                out.append(F.relu(y))
            return tuple(out)
        return list(self._run(f, *xs))

    def __call__(self, images):
        b = 'backbone'

        def stem(x):
            x = F.relu(self.bn(self.conv(x, b + '.conv1', 2), b + '.bn1'))
            return F.relu(self.bn(self.conv(x, b + '.conv2', 2), b + '.bn2'))

        x = self._run(stem, images)
        for i in range(4):
            x = self.bottleneck(x, f'{b}.layer1.{i}', i == 0)
        xs = [self._run(self.conv_bn, x, f'{b}.transition1.0'),
              self._run(self.conv_bn, x, f'{b}.transition1.1', 2)]
        for s, (modules, n) in enumerate(STAGES):
            if s:
                xs.append(self._run(self.conv_bn, xs[-1],
                                    f'{b}.transition{s + 1}.{n - 1}', 2))
            for m in range(modules):
                p = f'{b}.stage{s + 2}.{m}'
                for i in range(n):
                    for k in range(4):
                        xs[i] = self.basic(xs[i], f'{p}.branches.{i}.{k}')
                last = s == len(STAGES) - 1 and m == modules - 1
                xs = self.fuse(xs, p, 1 if last else n)
        return self.conv(xs[0], 'heatmap_head.final_layer')


def joints_mse(heatmaps, target, weight):
    """HRNet's JointsMSELoss(use_target_weight=True): Σ over landmarks of
    ½·MSE(ŷ_k·w_k, y_k·w_k) over the batch and pixels, over K."""
    k = heatmaps.shape[1]
    loss = 0.0
    for j in range(k):
        w = weight[:, j, None, None]
        loss = loss + 0.5 * F.mse_loss(heatmaps[:, j] * w, target[:, j] * w)
    return loss / k


class LandmarkReference:
    """The train step from float weights `weights` (parameters and batch
    norm statistics by the program's names), `trainable` the parameter
    names in the program's order; `rec` the recipe (rot_aug,
    rot_image_aug, k_net, mean, landmarks [K,3], sigma, heatmap_hw);
    `opt` lr, clip, weight_decay."""

    B1, B2, EPS = 0.9, 0.999, 1e-8

    def __init__(self, weights: Dict[str, torch.Tensor], trainable: List[str],
                 rec: dict, opt: dict, precision: str = 'f32',
                 checkpointed: bool = False):
        self.names = list(trainable)
        self.params = {n: weights[n].detach().clone().float()
                       .requires_grad_(True) for n in self.names}
        self.buffers = {n: v.detach().clone().float()
                        for n, v in weights.items() if n not in self.params}
        self.model = Model(self.params, precision, checkpointed)
        self.rec, self.opt = rec, opt
        self.slots = {s: {n: torch.zeros_like(p)
                          for n, p in self.params.items()}
                      for s in ('mu', 'nu', 'nu_max')}
        self.count = 0

    @torch.no_grad()
    def set_state(self, params: dict, slots: dict, count: int) -> None:
        """Take over a state: parameters and AMSGrad's slots by name, and
        the number of updates made so far."""
        for n in self.names:
            self.params[n].copy_(params[n])
            for k in self.slots:
                self.slots[k][n].copy_(slots[k][n])
        self.count = count

    def batch(self, raw: dict, gen: torch.Generator) -> dict:
        """The model batch of a raw one: images, targets, weights,
        landmark pixels."""
        rec = self.rec
        with torch.no_grad():
            images, locs, quats = augment(raw, gen, rec)
            pts = torch.as_tensor(rec['landmarks'], dtype=torch.float32,
                                  device=locs.device)
            pixels, depths = landmark_pixels(pts, locs, quats, rec['k_net'])
            tgt, wgt = targets(pixels, depths, rec['heatmap_hw'],
                               rec['sigma'])
        return {'images': images, 'target': tgt, 'weight': wgt,
                'pixels': pixels}

    def loss(self, batch: dict):
        """(loss, landmark loss, heatmaps) of the model batch."""
        heat = self.model(batch['images'])
        part = joints_mse(heat, batch['target'], batch['weight'])
        reg = self.opt['weight_decay'] * torch.stack(
            [torch.mean(self.params[n] ** 2) for n in self.names
             if not is_bn(n)]).sum()
        return part + reg, part, heat

    def step(self, raw: dict, gen: torch.Generator) -> dict:
        """One step on a raw batch; returns {'loss', 'parts',
        'global_norm', 'out_max'}."""
        return self.step_batch(self.batch(raw, gen))

    def step_batch(self, batch: dict) -> dict:
        """One step on a model batch (`batch`'s keys)."""
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        loss, part, heat = self.loss(batch)
        grads = torch.autograd.grad(loss, [self.params[n] for n in self.names])
        with torch.no_grad():
            g_norm = torch.linalg.vector_norm(torch.stack(
                [torch.linalg.vector_norm(g) for g in grads]))
            clip = self.opt['clip']
            factor = 1.0 if float(g_norm) < clip else clip / g_norm
            self.count += 1
            f32 = np.float32
            bc1 = float(f32(1.0) - f32(self.B1) ** f32(self.count))
            bc2 = float(f32(1.0) - f32(self.B2) ** f32(self.count))
            lr = self.opt['lr']
            for n, g in zip(self.names, grads):
                g = g * factor
                m, v = self.slots['mu'][n], self.slots['nu'][n]
                vmax = self.slots['nu_max'][n]
                m.copy_((1.0 - self.B1) * g + self.B1 * m)
                v.copy_((1.0 - self.B2) * (g * g) + self.B2 * v)
                torch.maximum(vmax, v / bc2, out=vmax)
                self.params[n].add_((m / bc1) / (torch.sqrt(vmax) + self.EPS)
                                    * -lr)
            for name, (mean, var) in self.model.stats.items():
                for leaf, s in (('running_mean', mean), ('running_var', var)):
                    r = self.buffers[f'{name}.{leaf}']
                    r.copy_(r * BN_MOMENTUM + s * (1 - BN_MOMENTUM))
            self.last_stats, self.model.stats = self.model.stats, {}
        return {'loss': float(loss.detach()),
                'parts': {'landmark_loss': float(part.detach())},
                'global_norm': float(g_norm),
                'out_max': {'heatmaps': float(heat.detach().abs().max())}}


def heatmap_hw(h: int, w: int) -> tuple:
    return (h // STRIDE, w // STRIDE)


def final_preds(heatmaps: np.ndarray):
    """HRNet's `get_max_preds` and `get_final_preds` with TEST.POST_PROCESS
    on [B,K,h,w] heatmaps, back to input pixels at STRIDE: (preds
    [B,K,2], maxvals [B,K,1])."""
    b, k, h, w = heatmaps.shape
    flat = heatmaps.reshape((b, k, -1))
    idx = np.argmax(flat, 2).reshape((b, k, 1))
    maxvals = np.amax(flat, 2).reshape((b, k, 1))
    preds = np.tile(idx, (1, 1, 2)).astype(np.float32)
    preds[:, :, 0] = (preds[:, :, 0]) % w
    preds[:, :, 1] = np.floor((preds[:, :, 1]) / w)
    pred_mask = np.tile(np.greater(maxvals, 0.0), (1, 1, 2))
    coords = preds * pred_mask.astype(np.float32)
    for n in range(b):
        for p in range(k):
            hm = heatmaps[n][p]
            px = int(np.floor(coords[n][p][0] + 0.5))
            py = int(np.floor(coords[n][p][1] + 0.5))
            if 1 < px < w - 1 and 1 < py < h - 1:
                diff = np.array([hm[py][px + 1] - hm[py][px - 1],
                                 hm[py + 1][px] - hm[py - 1][px]])
                coords[n][p] += np.sign(diff) * .25
    return coords * STRIDE, maxvals

