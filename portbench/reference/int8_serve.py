"""Plain reference of int8 post-training-quantized serving of the UrsoNet
ResNet-50/101 models, in plain PyTorch and NumPy.

It starts from the float weights the benchmark made (a state dict keyed
by the served model's layer names) and the calibration images, and works
out again everything the served model's set-up derives from them:

  * batch norm folded into the preceding conv: W' = W * g / sqrt(v + eps),
    b' = b * g / sqrt(v + eps) + beta - mean * g / sqrt(v + eps);
  * per-tensor activation scales, max |x| of the float model over the
    calibration images (convs in float32 with TF32 off);
  * SmoothQuant-style migration, m_c = a_c^alpha / w_c^(1 - alpha) over
    each channel space shared by producers and consumers;
  * weights per output channel, s_w = max |W| / qmax, w = clip(rint(W / s_w));
  * bias correction: per output channel, the mean of the int8
    pre-activation minus the float one on the calibration images, taken
    from the int8 biases one site at a time in graph order (re-measured
    after each site), for the given number of sweeps;
  * the int8 forward: integer products exact (float64 accumulation, no
    cuDNN), then the epilogue of each site: in the bf16 mode (F16) every
    step rounded to bf16 as the configuration states, in the f32 mode one
    fused multiply-add; requantize onto the next site's step with
    rint and a clip at qmax.

`qmax` = 127 is int8. The control runs the same arithmetic at qmax = 7,
int4: the nearest precision below the one the configuration states.

Activations are NHWC, conv kernels HWIO, dense kernels [in, out]. Nothing
here imports the program under test.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

BN_EPS = 1e-3
STAGE4_BLOCKS = {'resnet50': 5, 'resnet101': 22}


# --------------------------------------------------------------------------
# rounding helpers

def bf(x: torch.Tensor) -> torch.Tensor:
    """f32(bf16(f32(x))): one round to bf16 (RNE) of the f32 value."""
    return x.to(torch.float32).to(torch.bfloat16).to(torch.float32)


def fma_f32(x, y, z):
    """x * y + z rounded once to f32 (a hardware FMA): the product is exact
    in float64, TwoSum recovers the sum's error, and a sum that lands on a
    midpoint of two f32 values goes to the side of that error."""
    p = x.double() * y.double()
    zd = z.double()
    s = p + zd
    pp = s - zd
    e = (p - pp) + (zd - (s - pp))
    r = s.to(torch.float32)
    rd = r.double()
    toward = torch.where(s > rd, torch.full_like(r, float('inf')),
                         torch.full_like(r, float('-inf')))
    other = torch.nextafter(r, toward)
    mid = (rd + other.double()) * 0.5
    up = (s == mid) & (s != rd) & (e != 0) \
        & (torch.sign(e) == torch.sign(s - rd))
    return torch.where(up, other, r)


def f32(v, dev) -> torch.Tensor:
    return torch.tensor(np.float32(v), dtype=torch.float32, device=dev)


def inv_f32(step: float) -> float:
    """f32(1 / f32(step)): the multiplier that stands for `x / step`."""
    return float(np.float32(1.0) / np.float32(step))


def same_pads(n: int, k: int, s: int):
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def pads_of(padding, h, w, kh, kw, stride):
    if padding == 'VALID':
        return (0, 0), (0, 0)
    if padding == 'SAME':
        return same_pads(h, kh, stride), same_pads(w, kw, stride)
    return tuple(padding[0]), tuple(padding[1])


# --------------------------------------------------------------------------
# the model's sites

def blocks(arch: str):
    """(stage, block letter, stride, conv shortcut) of every bottleneck."""
    out = [(2, 'a', 1, True), (2, 'b', 1, False), (2, 'c', 1, False),
           (3, 'a', 2, True)]
    out += [(3, b, 1, False) for b in 'bcd']
    out.append((4, 'a', 2, True))
    out += [(4, chr(98 + i), 1, False) for i in range(STAGE4_BLOCKS[arch])]
    out += [(5, 'a', 2, True), (5, 'b', 1, False), (5, 'c', 1, False)]
    return out


def fold(sd: Dict[str, torch.Tensor], model: dict) -> Dict[str, tuple]:
    """{site: (kernel, bias)} as float32 numpy, batch norm folded: conv
    kernels HWIO, dense kernels [in, out]. `sd` is keyed by the served
    model's layer names (`backbone.res2a.res2a_branch2a.weight`,
    `backbone.res2a.bn2a_branch2a.running_var`, `loc_head.loc_dense_0.bias`)."""
    def get(key):
        return sd[key].detach().to('cpu', torch.float32).numpy()

    flat = {}

    def conv(site, prefix, bn):
        k = get(prefix + '.weight').transpose(2, 3, 1, 0)   # OIHW -> HWIO
        b = get(prefix + '.bias')
        g, beta = get(bn + '.weight'), get(bn + '.bias')
        mean, var = get(bn + '.running_mean'), get(bn + '.running_var')
        mul = g / np.sqrt(var + np.float32(BN_EPS))
        flat[site] = ((k * mul).astype(np.float32),
                      (b * mul + (beta - mean * mul)).astype(np.float32))

    conv('conv1', 'backbone.conv1', 'backbone.bn_conv1')
    for stage, blk, _, shortcut in blocks(model['backbone']):
        mod = f'backbone.res{stage}{blk}'
        for br in (['1'] if shortcut else []) + ['2a', '2b', '2c']:
            conv(f'res{stage}{blk}_branch{br}',
                 f'{mod}.res{stage}{blk}_branch{br}',
                 f'{mod}.bn{stage}{blk}_branch{br}')
    flat['bottleneck_layer'] = (
        get('bottleneck_layer.weight').transpose(2, 3, 1, 0).copy(),
        get('bottleneck_layer.bias'))
    for head in heads_of(model):
        for i in range(model['nr_dense_layers']):
            name = f'{head}_head.{head}_dense_{i}'
            flat[f'{head}_head/{head}_dense_{i}'] = (
                get(name + '.weight').T.copy(), get(name + '.bias'))
    for site in finals_of(model):
        name = site.replace('/', '.')
        flat[site] = (get(name + '.weight').T.copy(), get(name + '.bias'))
    return flat


def heads_of(model):
    return ['loc'] if model['regress_keypoints'] else ['loc', 'ori']


def finals_of(model):
    if model['regress_keypoints']:
        return ['loc_head/k1_final', 'loc_head/k2_final', 'loc_head/k3_final']
    return ['loc_head/loc_final', 'ori_head/ori_final']


def float_finals(model) -> set:
    """The final denses served in float: the keypoint and location
    regressions (the orientation classifier's final is int8)."""
    if model['regress_keypoints']:
        return set(finals_of(model))
    return {'loc_head/loc_final'}


def graph(ops, x, model):
    """The served graph over `ops`; returns {head: f32 [B, n]}."""
    y = ops.conv(ops.input(x), 'conv1', 2, ((3, 3), (3, 3)))
    y = ops.maxpool(ops.relu(y, 'conv1/out'))
    for stage, blk, stride, shortcut in blocks(model['backbone']):
        c = f'res{stage}{blk}_branch'
        sc = ops.requant(ops.conv(y, c + '1', stride, 'VALID'), c + '1/out') \
            if shortcut else y
        r = ops.relu(ops.conv(y, c + '2a', stride, 'VALID'), c + '2a/out')
        r = ops.relu(ops.conv(r, c + '2b', 1, 'SAME'), c + '2b/out')
        y = ops.join(ops.conv(r, c + '2c', 1, 'VALID'), sc, c + '/out')
    y = ops.conv(y, 'bottleneck_layer', 2, 'SAME')
    feats = ops.flatten(y, 'bottleneck/out')
    n = model['nr_dense_layers']

    def hidden(prefix, quant_last):
        h = feats
        for i in range(n):
            site = f'{prefix}_head/{prefix}_dense_{i}'
            keep = quant_last or i < n - 1
            h = ops.relu(ops.dense(h, site), site + '/out' if keep else None)
        return h

    if model['regress_keypoints']:
        h = hidden('loc', False)
        out = {'loc': ops.dense_final(h, 'loc_head/k1_final'),
               'k1': ops.dense_final(h, 'loc_head/k2_final'),
               'k2': ops.dense_final(h, 'loc_head/k3_final')}
    else:
        out = {'loc': ops.dense_final(hidden('loc', False),
                                      'loc_head/loc_final'),
               'ori': ops.relu(ops.dense(hidden('ori', True),
                                         'ori_head/ori_final'))}
    return ops.finalize(out)


def migration_groups(model) -> list:
    """Channel spaces for the migration: (activation sites, producers,
    consumers with their kind: 'conv' HWIO, 'dense' [in, out],
    'dense_flat' a dense over flattened NHWC features)."""
    groups = []

    def grp(acts, prods, cons):
        groups.append((list(acts), list(prods), list(cons)))

    grp(['conv1/out'], ['conv1'],
        [('res2a_branch2a', 'conv'), ('res2a_branch1', 'conv')])
    stages = {}
    for stage, blk, _, _ in blocks(model['backbone']):
        stages.setdefault(stage, []).append(blk)
    order = sorted(stages)
    for si, s in enumerate(order):
        acts, prods, cons = [], [], []
        for b in stages[s]:
            c = f'res{s}{b}_branch'
            grp([c + '2a/out'], [c + '2a'], [(c + '2b', 'conv')])
            grp([c + '2b/out'], [c + '2b'], [(c + '2c', 'conv')])
            prods.append(c + '2c')
            acts.append(c + '/out')
            if b != 'a':
                cons.append((c + '2a', 'conv'))
        prods.append(f'res{s}a_branch1')
        acts.append(f'res{s}a_branch1/out')
        if si + 1 < len(order):
            nxt = order[si + 1]
            cons += [(f'res{nxt}a_branch2a', 'conv'),
                     (f'res{nxt}a_branch1', 'conv')]
        else:
            cons.append(('bottleneck_layer', 'conv'))
        grp(acts, prods, cons)
    grp(['bottleneck/out'], ['bottleneck_layer'],
        [(f'{p}_head/{p}_dense_0', 'dense_flat') for p in heads_of(model)])
    n = model['nr_dense_layers']
    ffin = float_finals(model)
    for p in heads_of(model):
        final = 'loc_head/k1_final' if model['regress_keypoints'] \
            else f'{p}_head/{p}_final'
        for i in range(n):
            site = f'{p}_head/{p}_dense_{i}'
            nxt = f'{p}_head/{p}_dense_{i + 1}' if i < n - 1 else final
            if i == n - 1 and nxt in ffin:
                continue
            grp([site + '/out'], [site], [(nxt, 'dense')])
    return groups


# --------------------------------------------------------------------------
# the float model (calibration and the bias correction's float means)

def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def _mean_capture(capture, site, y):
    if capture is not None:
        y = y.to(torch.float32)
        capture[site] = torch.mean(y, dim=tuple(range(y.dim() - 1)))


class FloatOps:
    """The float model on folded weights (f32, TF32 off by the caller).
    `observe`: a dict that takes max |x| and the per-channel max at each
    quantize site; `capture`: a dict that takes each conv's and dense's
    per-channel output mean."""

    def __init__(self, w, mean_pixel, observe=None, capture=None):
        self.w = w
        self.mean = mean_pixel
        self.observe = observe
        self.capture = capture

    def _obs(self, site, x, per_channel=True):
        if self.observe is not None:
            a = torch.abs(x.to(torch.float32))
            self.observe.setdefault('max', {})[site] = torch.amax(a)
            if per_channel:
                self.observe.setdefault('chan', {})[site] = torch.amax(
                    a, dim=tuple(range(a.dim() - 1)))
        return x

    def input(self, x_u8):
        x = x_u8.to(torch.float32) - torch.tensor(
            np.asarray(self.mean, np.float32), device=x_u8.device)
        return self._obs('input', x, per_channel=False)

    def conv(self, x, site, stride, padding):
        k, b = self.w[site]
        (pt, pb), (pl, pr) = pads_of(padding, x.shape[1], x.shape[2],
                                     k.shape[2], k.shape[3], stride)
        xc = F.pad(_nchw(x), (pl, pr, pt, pb))
        y = _nhwc(F.conv2d(xc, k, stride=stride)) + b
        _mean_capture(self.capture, site, y)
        return y

    def dense(self, x, site):
        k, b = self.w[site]
        y = x @ k + b
        _mean_capture(self.capture, site, y)
        return y

    dense_final = dense

    def relu(self, x, site=None):
        y = torch.relu(x)
        return self._obs(site, y) if site else y

    def requant(self, x, site):
        return self._obs(site, x)

    def join(self, r, sc, site):
        return self._obs(site, torch.relu(r + sc))

    def maxpool(self, x):
        xc = _nchw(x)
        (pt, pb), (pl, pr) = same_pads(xc.shape[2], 3, 2), \
            same_pads(xc.shape[3], 3, 2)
        xc = F.pad(xc, (pl, pr, pt, pb), value=float('-inf'))
        return _nhwc(F.max_pool2d(xc, 3, 2))

    def flatten(self, x, site):
        self._obs(site, x)
        return x.reshape(x.shape[0], -1)

    def finalize(self, out):
        return {k: v.to(torch.float32) for k, v in out.items()}


# --------------------------------------------------------------------------
# the int8 model

class Q:
    """A quantized activation: integer values (in a float tensor) and its
    step."""

    __slots__ = ('v', 'step')

    def __init__(self, v, step):
        self.v, self.step = v, step


class P:
    """A pending conv or dense product, resolved by its consumer's
    epilogue."""

    __slots__ = ('x', 'site', 'stride', 'padding')

    def __init__(self, x, site, stride=1, padding=None):
        self.x, self.site, self.stride, self.padding = x, site, stride, padding


class IntOps:
    """The integer model: exact products, then the epilogues in the mode
    `acc` ('bf16' or 'f32'); activations clip at `qmax`. `capture`: a
    dict that takes each product's per-channel pre-activation mean."""

    def __init__(self, q, ffinal, scales, mean_pixel, acc='bf16', qmax=127,
                 capture=None):
        self.q = q
        self.ffinal = ffinal
        self.scales = {k: max(float(v), 1e-10) for k, v in scales.items()}
        self.mean = mean_pixel
        self.bf16 = acc == 'bf16'
        self.qmax = float(qmax)
        self.capture = capture

    def step(self, site):
        return self.scales[site] / self.qmax

    def _q(self, x, site):
        s = self.step(site)
        y = torch.round(x.to(torch.float32) * f32(inv_f32(s), x.device))
        return Q(torch.clamp(y, -self.qmax, self.qmax), s)

    def input(self, x_u8):
        x = x_u8.to(torch.float32) - torch.tensor(
            np.asarray(self.mean, np.float32), device=x_u8.device)
        return self._q(x, 'input')

    def conv(self, x, site, stride, padding):
        return P(x, site, stride, padding)

    def dense(self, x, site):
        return P(x, site)

    def _acc(self, p: P):
        w = self.q[p.site][0]
        x = p.x.v.to(torch.float64)
        if p.padding is None:
            return x @ w
        (pt, pb), (pl, pr) = pads_of(p.padding, x.shape[1], x.shape[2],
                                     w.shape[0], w.shape[1], p.stride)
        if w.shape[0] == 1 and w.shape[1] == 1 and not (pt or pb or pl or pr):
            xs = x[:, ::p.stride, ::p.stride, :]
            return xs @ w[0, 0]
        xc = F.pad(_nchw(x), (pl, pr, pt, pb))
        with torch.backends.cudnn.flags(enabled=False):
            y = F.conv2d(xc, w.permute(3, 2, 0, 1), stride=p.stride)
        # NHWC in memory: the per-channel means sum in that order
        return _nhwc(y).contiguous()

    def _sum(self, acc, alpha, beta):
        if self.bf16:
            return bf(bf(acc) * bf(alpha)) + bf(beta)
        return fma_f32(acc.to(torch.float32), alpha, beta)

    def _run(self, p: P, kind, out_site=None, res=None, res_scale=1.0):
        _, sw, b = self.q[p.site]
        dev = sw.device
        alpha = sw * f32(p.x.step, dev)
        acc = self._acc(p)
        s = self._sum(acc, alpha, b)
        _mean_capture(self.capture, p.site, s)
        y = bf(s) if self.bf16 else s
        if kind == 'f32':
            return y
        if kind == 'f32_relu':
            return torch.clamp_min(y, 0.0)
        step = self.step(out_site)
        inv = f32(inv_f32(step), dev)
        if kind == 'q8':
            return Q(torch.clamp(torch.round(s * inv), -self.qmax, self.qmax),
                     step)
        if kind == 'join':
            r = res.to(torch.float32)
            if self.bf16:
                y = bf(y + bf(r * bf(f32(res_scale, dev))))
            else:
                y = y + r * f32(res_scale, dev)
        y = torch.clamp_min(y, 0.0)
        return Q(torch.clamp(torch.round(y * inv), 0, self.qmax), step)

    def relu(self, x, site=None):
        if isinstance(x, P):
            return self._run(x, 'q8_relu', site) if site \
                else self._run(x, 'f32_relu')
        return torch.relu(self._float(x))

    def requant(self, x, site):
        return self._run(x, 'q8', site)

    def join(self, r, sc, site):
        return self._run(r, 'join', site, sc.v, float(np.float32(sc.step)))

    def maxpool(self, x):
        xc = _nchw(x.v)
        (pt, pb), (pl, pr) = same_pads(xc.shape[2], 3, 2), \
            same_pads(xc.shape[3], 3, 2)
        xc = F.pad(xc, (pl, pr, pt, pb), value=-128.0)
        return Q(_nhwc(F.max_pool2d(xc, 3, 2)), x.step)

    def flatten(self, x, site):
        if self.bf16:
            y = self._run(x, 'f32')
            return self._q(y.reshape(y.shape[0], -1), site)
        y = self._run(x, 'q8', site)
        return Q(y.v.reshape(y.v.shape[0], -1), y.step)

    def _float(self, x):
        if not isinstance(x, Q):
            return x
        scale = f32(x.step, x.v.device)
        if self.bf16:
            return bf(x.v * bf(scale))
        return x.v * scale

    def dense_final(self, x, site):
        x = self._float(x)
        w, b = self.ffinal[site]
        if self.bf16:
            dt = torch.bfloat16
            return (x.to(dt) @ w.to(dt)).to(torch.float32) \
                + b.to(dt).to(torch.float32)
        return x @ w + b

    def finalize(self, out):
        return {k: self._float(v).to(torch.float32) for k, v in out.items()}


# --------------------------------------------------------------------------
# set-up and serving

def _no_tf32():
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def quantize_weight(w: np.ndarray, qmax: int):
    axes = tuple(range(w.ndim - 1))
    sw = np.maximum(np.abs(w).max(axis=axes), 1e-12) / np.float32(qmax)
    w8 = np.clip(np.round(w / sw), -qmax, qmax)
    return w8.astype(np.float32), sw.astype(np.float32)


class Int8Reference:
    """The served model worked out from float weights and calibration
    images. `model`: backbone, nr_dense_layers, regress_keypoints,
    mean_pixel; `acc`: 'bf16' (F16) or 'f32'; `qmax` 127 (int8) or 7
    (int4, the control)."""

    def __init__(self, sd, model: dict, device, acc='bf16', qmax=127):
        self.model = model
        self.dev = torch.device(device)
        self.acc = acc
        self.qmax = qmax
        self.flat = fold(sd, model)
        self.scales: Optional[dict] = None
        self.chan: Optional[dict] = None
        self.delta: Dict[str, np.ndarray] = {}
        self._base = None

    def _float_w(self):
        """The float weights on the device: conv kernels OIHW, laid out
        channels-last on the card, where the convolutions run on NHWC
        activations."""
        fmt = torch.channels_last if self.dev.type == 'cuda' \
            else torch.contiguous_format
        w = {}
        for s, (k, b) in self.flat.items():
            kt = torch.from_numpy(k)
            if kt.dim() == 4:
                kt = kt.permute(3, 2, 0, 1).contiguous(memory_format=fmt)
            w[s] = (kt.to(self.dev), torch.from_numpy(b).to(self.dev))
        return w

    def _float_forward(self, x, observe=None, capture=None):
        _no_tf32()
        with torch.no_grad():
            ops = FloatOps(self._float_w(), self.model['mean_pixel'],
                           observe, capture)
            return graph(ops, x.to(self.dev), self.model)

    def calibrate(self, x_u8):
        obs = {}
        self._float_forward(x_u8, observe=obs)
        self.scales = {k: float(v) for k, v in obs['max'].items()}
        self.chan = {k: v.cpu().numpy() for k, v in obs['chan'].items()}

    def smooth(self, alpha: float):
        flat = {s: (k.copy(), b.copy()) for s, (k, b) in self.flat.items()}
        for acts, prods, cons in migration_groups(self.model):
            a = np.maximum.reduce([np.asarray(self.chan[s], np.float32)
                                   for s in acts])
            c = a.shape[0]
            ws = []
            for site, kind in cons:
                k = flat[site][0]
                if kind == 'conv':
                    ws.append(np.abs(k).max(axis=(0, 1, 3)))
                elif kind == 'dense':
                    ws.append(np.abs(k).max(axis=1))
                else:
                    ws.append(np.abs(k.reshape(-1, c, k.shape[-1]))
                              .max(axis=(0, 2)))
            w = np.maximum.reduce(ws)
            m = np.where(a > 0, a ** alpha / np.maximum(w, 1e-12)
                         ** (1 - alpha), 1.0)
            m = np.where(np.isfinite(m), np.clip(m, 1e-4, 1e4), 1.0) \
                .astype(np.float32)
            for p in prods:
                k, b = flat[p]
                flat[p] = (k / m, b / m)
            for site, kind in cons:
                k, b = flat[site]
                if kind == 'conv':
                    k = k * m[None, None, :, None]
                elif kind == 'dense':
                    k = k * m[:, None]
                else:
                    k = (k.reshape(-1, c, k.shape[-1])
                         * m[None, :, None]).reshape(k.shape)
                flat[site] = (k, b)
            for s in acts:
                cm = np.asarray(self.chan[s], np.float32) / m
                self.chan[s] = cm
                self.scales[s] = float(cm.max())
        self.flat = flat
        self._base = None

    def _qweights(self):
        """({site: (integer kernel f64, s_w, bias + correction)}, {float
        final: (kernel, bias)}) on the device; the kernels are quantized
        once a set of float weights."""
        floats = float_finals(self.model)
        if self._base is None:
            base, ffin = {}, {}
            for site, (k, b) in self.flat.items():
                if site in floats:
                    ffin[site] = (torch.from_numpy(k).to(self.dev),
                                  torch.from_numpy(b).to(self.dev))
                    continue
                w8, sw = quantize_weight(k, self.qmax)
                base[site] = (torch.from_numpy(w8).to(self.dev, torch.float64),
                              torch.from_numpy(sw).to(self.dev), b)
            self._base = base, ffin
        base, ffin = self._base
        q = {}
        for site, (w8, sw, b) in base.items():
            b = b + self.delta.get(site, np.float32(0.0))
            q[site] = (w8, sw, torch.from_numpy(np.asarray(b, np.float32))
                       .to(self.dev))
        return q, ffin

    def _int_forward(self, x, capture=None, q=None):
        q, ffin = self._qweights() if q is None else q
        _no_tf32()
        with torch.no_grad():
            ops = IntOps(q, ffin, self.scales, self.model['mean_pixel'],
                         self.acc, self.qmax, capture)
            return graph(ops, x.to(self.dev), self.model)

    def bias_correct(self, x_u8, passes: int = 1):
        fmeans = {}
        self._float_forward(x_u8, capture=fmeans)
        fmeans = {k: v.cpu().numpy() for k, v in fmeans.items()}
        floats = float_finals(self.model)

        def qmeans():
            cap = {}
            self._int_forward(x_u8, capture=cap)
            return cap

        for _ in range(max(1, passes)):
            means = qmeans()
            sites = [s for s in means if s not in floats]
            for i, site in enumerate(sites):
                err = means[site].cpu().numpy() - fmeans[site]
                self.delta[site] = np.asarray(
                    self.delta.get(site, 0.0) - err, np.float32)
                if i + 1 < len(sites):
                    means = qmeans()

    def prepare(self, calib_u8, alpha: float, passes: int):
        """calibrate, smooth(alpha), bias_correct(passes): the served
        model's set-up."""
        self.calibrate(calib_u8)
        self.smooth(alpha)
        if passes:
            self.bias_correct(calib_u8, passes)

    def serve(self, x_u8, rows: int = 32) -> Dict[str, torch.Tensor]:
        """The heads of a raw uint8 batch [B,H,W,3], in blocks of `rows`,
        on the host."""
        q = self._qweights()
        parts: List[dict] = []
        for lo in range(0, x_u8.shape[0], rows):
            out = self._int_forward(x_u8[lo:lo + rows], q=q)
            parts.append({k: v.cpu() for k, v in out.items()})
        return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
