"""Plain reference of the UrsoNet train step on a device-resident dataset,
in plain PyTorch: float32 with TF32 off, no kernels of the program.

One step, as the configuration states it: gather the batch's rows of the
dataset; draw the rotation augmentation (per image a dice, camera Euler
angles in ±10° per axis, a roll in ±85°); the camera rotation for a dice
above 0.5, the in-plane roll otherwise (ROT_AUG, ROT_IMAGE_AUG), applied
to the pose and, as a homography K R K⁻¹ at the network's resolution, to
the image by nearest sampling (zero outside); subtract the pixel mean;
the orientation target re-encoded as a Gaussian-kernel PMF over the
bins³ Euler grid (BETA), or the keypoints moved with the pose; the
forward of the ResNet with frozen batch norm, the 3x3/2 bottleneck conv,
the NHWC flatten and the heads; the losses (location: ‖Y − Ŷ‖ / ‖Y‖ over
the batch; orientation: soft-target softmax cross-entropy on the ReLU
outputs; keypoints: mean squared errors) plus WEIGHT_DECAY · Σ mean(w²)
over the weights outside batch norm; the gradient; the clip by global
norm; Keras momentum SGD, v ← m v − lr g, w ← w + v.

`precision='fp8'` is the control: every conv and dense computes on its
operands rounded to float8 (per-tensor scales: e4m3 for activations and
weights, e5m2 for the gradients the backward products take), one
precision below the configuration's bf16.

The augmentation's draws and arithmetic follow the published recipe in
the order the configuration's generator draws them (`draw_rotation`),
written out here again from the formulas.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

BN_EPS = 1e-3
STAGE4_BLOCKS = {'resnet50': 5, 'resnet101': 22}
_DEG = math.pi / 180.0


# --------------------------------------------------------------------------
# camera and geometry

def urso_camera_k() -> np.ndarray:
    """URSO's render camera: 90° x 73.7° FOV at 1280 x 960, y down."""
    w, h = 1280, 960
    fx = w / (2 * np.tan(90.0 * np.pi / 180 / 2))
    fy = -h / (2 * np.tan(73.7 * np.pi / 180 / 2))
    return np.array([[fx, 0, w / 2], [0, fy, h / 2], [0, 0, 1]])


def net_intrinsics(k, window, scale) -> np.ndarray:
    """K at the network's resolution: scaled, offset by the pad window."""
    y1, x1 = window[0], window[1]
    s = np.array([[scale, 0, x1], [0, scale, y1], [0, 0, 1.0]])
    return s @ np.asarray(k, np.float64)


def euler_to_rot(pitch, yaw, roll):
    """Euler angles (degrees) to a rotation, left-handed XYZ order."""
    cp, sp = torch.cos(pitch * _DEG), torch.sin(pitch * _DEG)
    cy, sy = torch.cos(yaw * _DEG), torch.sin(yaw * _DEG)
    cr, sr = torch.cos(roll * _DEG), torch.sin(roll * _DEG)
    rows = [torch.stack([cy * cr, sp * sy * cr - cp * sr,
                         cp * sy * cr + sp * sr], -1),
            torch.stack([cy * sr, sp * sy * sr + cp * cr,
                         cp * sy * sr - sp * cr], -1),
            torch.stack([-sy, sp * cy, cp * cy], -1)]
    return torch.stack(rows, dim=-2)


def rot_to_quat(r):
    """Rotation to a scalar-last quaternion (Shepperd's four cases)."""
    r00, r01, r02 = r[..., 0, 0], r[..., 0, 1], r[..., 0, 2]
    r10, r11, r12 = r[..., 1, 0], r[..., 1, 1], r[..., 1, 2]
    r20, r21, r22 = r[..., 2, 0], r[..., 2, 1], r[..., 2, 2]
    tr = r00 + r11 + r22

    def z_of(v):
        return torch.sqrt(torch.clamp(v, min=1e-12)) * 2.0

    def pack(*q):
        return torch.stack(q, dim=-1)

    zw = z_of(tr + 1.0)
    qw = pack((r12 - r21) / zw, (r20 - r02) / zw, (r01 - r10) / zw, 0.25 * zw)
    zx = z_of(1.0 + 2.0 * r00 - tr)
    qx = pack(0.25 * zx, (r01 + r10) / zx, (r02 + r20) / zx, (r12 - r21) / zx)
    zy = z_of(1.0 + 2.0 * r11 - tr)
    qy = pack((r01 + r10) / zy, 0.25 * zy, (r12 + r21) / zy, (r20 - r02) / zy)
    zz = z_of(1.0 + 2.0 * r22 - tr)
    qz = pack((r02 + r20) / zz, (r12 + r21) / zz, 0.25 * zz, (r01 - r10) / zz)
    return torch.where((tr > 0)[..., None], qw,
                       torch.where(((r00 > r11) & (r00 > r22))[..., None], qx,
                                   torch.where((r11 > r22)[..., None], qy,
                                               qz)))


def quat_to_rot(q):
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    rows = [torch.stack([1 - 2 * y * y - 2 * z * z, 2 * (x * y + z * w),
                         2 * (x * z - y * w)], -1),
            torch.stack([2 * (x * y - z * w), 1 - 2 * x * x - 2 * z * z,
                         2 * (y * z + x * w)], -1),
            torch.stack([2 * (x * z + y * w), 2 * (y * z - x * w),
                         1 - 2 * x * x - 2 * y * y], -1)]
    return torch.stack(rows, dim=-2)


def quat_mul(a, b):
    a0, a1, a2, a3 = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    b0, b1, b2, b3 = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    c = torch.stack([a3 * b0 + a2 * b1 - a1 * b2 + a0 * b3,
                     -a2 * b0 + a3 * b1 + a0 * b2 + a1 * b3,
                     a1 * b0 - a0 * b1 + a3 * b2 + a2 * b3,
                     -a0 * b0 - a1 * b1 - a2 * b2 + a3 * b3], dim=-1)
    return c / torch.linalg.vector_norm(c, dim=-1, keepdim=True)


def ori_grid(bins: int):
    """(bin quaternions float32 [bins³, 4], redundant-bin mask) of the
    Euler grid pitch, roll in [-180, 180], yaw in [-90, 90]."""
    lo = np.array([-180.0, -90.0, -180.0])
    hi = np.array([180.0, 90.0, 180.0])
    lin = np.linspace(0.0, 1.0, bins)
    g = np.stack([a.ravel() for a in np.meshgrid(lin, lin, lin,
                                                 indexing='ij')], 1)
    e = g * (hi - lo) + lo
    half = _DEG / 2.0
    cp, sp = np.cos(e[:, 0] * half), np.sin(e[:, 0] * half)
    cy, sy = np.cos(e[:, 1] * half), np.sin(e[:, 1] * half)
    cr, sr = np.cos(e[:, 2] * half), np.sin(e[:, 2] * half)
    quat = np.stack([sy * sr * cp - cy * cr * sp,
                     -sy * cr * cp - cy * sr * sp,
                     -cy * sr * cp + sy * cr * sp,
                     cy * cr * cp + sy * sr * sp], -1).astype(np.float32)
    mask = (e[:, 0] == hi[0]) | (e[:, 2] == hi[2]) \
        | ((np.abs(e[:, 1]) == hi[1]) & (e[:, 0] != lo[0]))
    return quat, mask


def ori_pmf(q, grid_q, mask, beta: float, bins: int):
    var = (beta / bins) ** 2 / 12.0
    dots = torch.abs(q @ grid_q.T)
    ang = torch.arccos(torch.clamp(dots, max=1.0)) / np.pi
    h = torch.exp(-2.0 * ang ** 2 / var)
    h = torch.where(mask, torch.zeros_like(h), h)
    return h / torch.sum(h, dim=-1, keepdim=True)


# --------------------------------------------------------------------------
# augmentation

def draw_rotation(gen: torch.Generator, b: int, magnitude: float = 20.0):
    """Per image: a dice in [0, 1), camera Euler angles in ±magnitude/2
    degrees, a roll in ±85 degrees; in this order from `gen`."""
    dev = gen.device
    dice = torch.rand(b, generator=gen, device=dev)
    pyr_cam = (torch.rand(b, 3, generator=gen, device=dev) - 0.5) * magnitude
    roll = (torch.rand(b, 1, generator=gen, device=dev) - 0.5) * 170.0
    return dice, pyr_cam, roll


def warp_mold(src_u8, m, identity, mean):
    """dst(x, y) = src(round(M (x, y, 1))) by nearest sampling (half to
    even, zero outside), the drawn images only; minus the pixel mean.
    src [B,H,W,3] uint8 -> [B,3,H,W] float32."""
    img = src_u8.permute(0, 3, 1, 2).to(torch.float32)
    b, c, h, w = img.shape
    xs = torch.arange(w, dtype=torch.float32, device=img.device).view(1, 1, w)
    ys = torch.arange(h, dtype=torch.float32, device=img.device).view(1, h, 1)

    def mm(i, j):
        return m[:, i, j].reshape(-1, 1, 1)

    den = mm(2, 0) * xs + mm(2, 1) * ys + mm(2, 2)
    sx = torch.round((mm(0, 0) * xs + mm(0, 1) * ys + mm(0, 2)) / den)
    sy = torch.round((mm(1, 0) * xs + mm(1, 1) * ys + mm(1, 2)) / den)
    ok = (sx >= 0) & (sx <= w - 1) & (sy >= 0) & (sy <= h - 1)
    idx = torch.where(ok, sy, 0).long() * w + torch.where(ok, sx, 0).long()
    v = torch.gather(img.reshape(b, c, h * w), 2,
                     idx.reshape(b, 1, h * w).expand(b, c, h * w))
    v = torch.where(ok[:, None], v.reshape(b, c, h, w), 0.0)
    out = torch.where(identity[:, None, None, None], img, v)
    return out - torch.as_tensor(np.asarray(mean, np.float32),
                                 device=img.device).view(1, 3, 1, 1)


def preprocess(raw: dict, gen: torch.Generator, rec: dict) -> dict:
    """The model batch of a raw batch and the step's draws. `rec`: the
    recipe (rot_aug, rot_image_aug, k_net, mean, keypoints, kp_scale,
    bins, beta, grid)."""
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
    batch = {'images': warp_mold(raw['images_u8'], m, identity, rec['mean']),
             'gt_loc': locs2}
    if rec['keypoints']:
        rr = quat_to_rot(quats2)
        batch['gt_k1'] = rr[..., :, 2] * rec['kp_scale'] + locs2
        batch['gt_k2'] = rr[..., :, 1] * rec['kp_scale'] + locs2
    else:
        gq, gm = rec['grid']
        batch['gt_ori'] = ori_pmf(quats2, gq, gm, rec['beta'], rec['bins'])
    return batch


# --------------------------------------------------------------------------
# the model

def _round8(x, dtype, top: float):
    """x rounded to an 8-bit float type with a per-tensor scale."""
    s = x.detach().abs().amax().clamp_min(1e-30) / top
    return (x / s).to(dtype).to(x.dtype) * s


class _Grad8(torch.autograd.Function):
    """Identity forward; the gradient rounded to float8 e5m2 backward, so
    that the backward products take 8-bit operands (the control)."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _round8(g, torch.float8_e5m2, 57344.0)


def _fp8(x):
    """x rounded to float8 e4m3 (per-tensor scale), the gradient passed
    straight through (the control)."""
    return x + (_round8(x, torch.float8_e4m3fn, 448.0) - x).detach()


class Model:
    """The functional float model over a parameter dict keyed by the
    program's layer names (`backbone.res2a.res2a_branch2a.weight`)."""

    def __init__(self, params: Dict[str, torch.Tensor],
                 buffers: Dict[str, torch.Tensor], model: dict,
                 precision: str = 'f32'):
        self.p, self.b, self.m = params, buffers, model
        self.fp8 = precision == 'fp8'

    def _q(self, x):
        return _fp8(x) if self.fp8 else x

    def conv(self, x, name, stride=1, padding=0):
        y = F.conv2d(self._q(x), self._q(self.p[name + '.weight']),
                     self.p[name + '.bias'], stride, padding)
        return _Grad8.apply(y) if self.fp8 else y

    def bn(self, x, name):
        return F.batch_norm(x, self.b[name + '.running_mean'],
                            self.b[name + '.running_var'],
                            self.p[name + '.weight'], self.p[name + '.bias'],
                            training=False, eps=BN_EPS)

    def dense(self, x, name):
        y = F.linear(self._q(x), self._q(self.p[name + '.weight']),
                     self.p[name + '.bias'])
        return _Grad8.apply(y) if self.fp8 else y

    def __call__(self, images) -> Dict[str, torch.Tensor]:
        y = F.relu(self.bn(self.conv(images, 'backbone.conv1', 2, 3),
                           'backbone.bn_conv1'))
        y = F.max_pool2d(_pad_same(y, 3, 2, float('-inf')), 3, 2)
        for stage, blk, stride, shortcut in _blocks(self.m['backbone']):
            mod = f'backbone.res{stage}{blk}'
            c, bn = f'{mod}.res{stage}{blk}_branch', f'{mod}.bn{stage}{blk}_branch'
            r = F.relu(self.bn(self.conv(y, c + '2a', stride), bn + '2a'))
            r = F.relu(self.bn(self.conv(r, c + '2b', 1, 1), bn + '2b'))
            r = self.bn(self.conv(r, c + '2c'), bn + '2c')
            sc = self.bn(self.conv(y, c + '1', stride), bn + '1') \
                if shortcut else y
            y = F.relu(r + sc)
        y = self.conv(_pad_same(y, 3, 2), 'bottleneck_layer', 2)
        feats = y.permute(0, 2, 3, 1).reshape(y.shape[0], -1)
        n = self.m['nr_dense_layers']

        def hidden(p):
            h = feats
            for i in range(n):
                h = F.relu(self.dense(h, f'{p}_head.{p}_dense_{i}'))
            return h

        if self.m['regress_keypoints']:
            h = hidden('loc')
            return {'loc': self.dense(h, 'loc_head.k1_final'),
                    'k1': self.dense(h, 'loc_head.k2_final'),
                    'k2': self.dense(h, 'loc_head.k3_final')}
        return {'loc': self.dense(hidden('loc'), 'loc_head.loc_final'),
                'ori': F.relu(self.dense(hidden('ori'), 'ori_head.ori_final'))}


def _blocks(arch):
    out = [(2, 'a', 1, True), (2, 'b', 1, False), (2, 'c', 1, False),
           (3, 'a', 2, True)] + [(3, b, 1, False) for b in 'bcd']
    out.append((4, 'a', 2, True))
    out += [(4, chr(98 + i), 1, False) for i in range(STAGE4_BLOCKS[arch])]
    return out + [(5, 'a', 2, True), (5, 'b', 1, False), (5, 'c', 1, False)]


def _pad_same(x, k, s, value=0.0):
    def pads(n):
        out = -(-n // s)
        total = max((out - 1) * s + k - n, 0)
        return total // 2, total - total // 2
    (t, b), (l, r) = pads(x.shape[2]), pads(x.shape[3])
    return F.pad(x, (l, r, t, b), value=value)


def is_bn(name: str) -> bool:
    layer = name.rsplit('.', 2)[-2]
    return layer.startswith('bn')


def losses(out, batch, keypoints: bool) -> Dict[str, torch.Tensor]:
    if keypoints:
        return {'loc_loss': torch.mean((batch['gt_loc'] - out['loc']) ** 2),
                'k2_loss': torch.mean((batch['gt_k1'] - out['k1']) ** 2),
                'k3_loss': torch.mean((batch['gt_k2'] - out['k2']) ** 2)}
    y = batch['gt_loc']
    loc = torch.linalg.vector_norm((y - out['loc']) / torch.linalg.vector_norm(y))
    logp = F.log_softmax(out['ori'], dim=-1)
    ori = torch.mean(-torch.sum(batch['gt_ori'] * logp, dim=-1))
    return {'loc_loss': loc, 'ori_loss': ori}


class TrainReference:
    """The train step of `model` (count.py's shape dict) from float
    weights `weights` (parameters and batch-norm statistics by the
    program's names); `rec` the augmentation recipe (see `preprocess`);
    `opt` lr, momentum, clip, weight_decay, loss_weights."""

    def __init__(self, weights: Dict[str, torch.Tensor], trainable: List[str],
                 model: dict, rec: dict, opt: dict, precision: str = 'f32'):
        self.names = list(trainable)
        self.params = {n: weights[n].detach().clone().float()
                       .requires_grad_(True) for n in self.names}
        self.buffers = {n: v.detach().clone().float()
                        for n, v in weights.items() if n not in self.params}
        self.model = Model(self.params, self.buffers, model, precision)
        self.keypoints = model['regress_keypoints']
        self.rec, self.opt = rec, opt
        self.velocity = {n: torch.zeros_like(p)
                         for n, p in self.params.items()}

    def step(self, raw: dict, gen: torch.Generator) -> dict:
        """One step; returns {'loss', 'grad_norms' {leaf: norm of the
        clipped gradient the update took}}."""
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        with torch.no_grad():
            batch = preprocess(raw, gen, self.rec)
        out = self.model(batch['images'])
        parts = losses(out, batch, self.keypoints)
        total = sum(v * self.opt['loss_weights'].get(k, 1.0)
                    for k, v in parts.items())
        reg = self.opt['weight_decay'] * torch.stack(
            [torch.mean(self.params[n] ** 2) for n in self.names
             if not is_bn(n)]).sum()
        loss = total + reg
        grads = torch.autograd.grad(loss, [self.params[n] for n in self.names])
        with torch.no_grad():
            norms = torch.stack([torch.linalg.vector_norm(g) for g in grads])
            g_norm = torch.linalg.vector_norm(norms)
            clip = self.opt['clip']
            factor = 1.0 if float(g_norm) < clip else clip / g_norm
            out_norms = {}
            for n, g in zip(self.names, grads):
                g = g * factor
                out_norms[n] = float(torch.linalg.vector_norm(g))
                v = self.velocity[n]
                v.mul_(self.opt['momentum']).sub_(g, alpha=self.opt['lr'])
                self.params[n].add_(v)
        return {'loss': float(loss.detach()), 'grad_norms': out_norms,
                'parts': {k: float(v.detach()) for k, v in parts.items()},
                'global_norm': float(g_norm),
                'out_max': {k: float(v.detach().abs().max())
                            for k, v in out.items()}}
