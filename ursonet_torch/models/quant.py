"""Post-training int8 quantization (PTQ) for serving: the port of
`ursonet_tpu/models/quant.py`.

Scheme (symmetric PTQ, as the JAX package):
  * weights per output channel: s_w[o] = max|W[..,o]| / 127
  * activations per tensor, calibrated: s_x = max|x| / 127 over a
    calibration batch
  * conv/dense: int8 x int8 -> int32, then y = acc * (s_x*s_w) + b, ReLU,
    and the next site's requantize, all in the kernel's epilogue.

One twin graph (`twin_forward`) drives three phases through an ops
object: the float reference (`F32Ops`), the max-abs calibration
(`CalibOps`) and the int8 serving pass (`Int8Ops`). Activations are NHWC,
kernels HWIO and [in, out], and sites carry the JAX package's names, so
the phases compare with the JAX package's site for site.

On the card, `Int8Ops` computes every int8 product through the two
hand-written kernels of `ops/int8_cuda.py`: `conv_s8` for the 7x7/2 stem,
the 3x3 convs and the 3x3/2 bottleneck conv, `gemm_s8` for the 1x1 convs
and the int8 head denses. A conv or dense returns a pending product that
its consumer (ReLU + requantize, shortcut requantize, residual join,
flatten) resolves with the matching fused epilogue, so no s32
accumulator or float activation is written between two int8 sites. The
maxpool, the input quantize and the float final dense stay plain
PyTorch ops, as they were XLA ops in the JAX package.

Not ported (NotImplementedError): bias_correct, shard_over, the s2d and
host-s2d stems, the bf16 stem, s8_join, F16 (bf16 epilogues) and the
ResNet-18/34 twin.

Usage:
    qm = QuantizedModel.from_variables(config, params, batch_stats)
    qm.calibrate(molded_images)            # one representative batch
    qm.smooth(0.5)                         # optional
    outputs = qm(images)                   # int8 forward
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ursonet_torch.device import resolve_device
from ursonet_torch.models.folding import _bn_name_for, fold_bn
from ursonet_torch.models.resnet import same_pads
from ursonet_torch.ops import int8_cuda

# Accuracy-gate thresholds of the JAX package (bench.py, test_quant.py):
# int8 vs float twin on the committed trained artifact, and on a
# random-init model.
TRAINED_GATE_REL = 0.08
RANDOM_INIT_GATE_REL = 0.15


@contextlib.contextmanager
def no_tf32():
    """Full f32 convolutions and matmuls inside, restored after: the
    activation scales are max|x| of f32 activations."""
    conv, mm = (torch.backends.cudnn.allow_tf32,
                torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = conv
        torch.backends.cuda.matmul.allow_tf32 = mm


# --------------------------------------------------------------------------
# Folded parameter flattening: {site_name: (kernel, effective_bias)}
# --------------------------------------------------------------------------

def flatten_folded(params, batch_stats, config) -> Dict[str, tuple]:
    """Fold BN and flatten the param tree (JAX layout, numpy) into
    per-site (kernel, bias). Head sites get a 'loc_head/' / 'ori_head/'
    prefix; backbone conv names are unique already. The BN shift becomes
    part of the site bias."""
    if getattr(config, 'TRAIN_BN', False):
        raise NotImplementedError(
            'int8 PTQ supports the TRAIN_BN=False default only')
    params, batch_stats = fold_bn(params, batch_stats or {})
    flat: Dict[str, tuple] = {}

    def add(site, node, parent):
        k = np.asarray(node['kernel'], np.float32)
        b = np.asarray(node['bias'], np.float32) if 'bias' in node \
            else np.zeros((k.shape[-1],), np.float32)
        bn = _bn_name_for(site.split('/')[-1])
        if bn and bn in parent:  # folded BN shift
            b = b + np.asarray(parent[bn]['bn']['bias'], np.float32)
        flat[site] = (k, b)

    def walk(node, prefix):
        for name, sub in node.items():
            if not isinstance(sub, dict):
                continue
            if 'kernel' in sub:
                add(prefix + name if prefix else name, sub, node)
            else:
                child_prefix = f'{name}/' if name.endswith('_head') \
                    else prefix
                walk(sub, child_prefix)

    walk(params, '')
    return flat


def quantize_weight(w):
    """Per-output-channel symmetric int8 quantization of a kernel, bit
    for bit the JAX package's formula (a serving artifact stores w8 and
    sw; re-quantizing w8 * sw gives w8 back). Returns (w8, sw f32[Cout])."""
    w = np.asarray(w, np.float32)
    axes = tuple(range(w.ndim - 1))
    sw = np.maximum(np.abs(w).max(axis=axes), 1e-12) / 127.0
    w8 = np.clip(np.round(w / sw), -127, 127).astype(np.int8)
    return w8, sw.astype(np.float32)


def _pads(padding, h, w, kh, kw, stride):
    """JAX padding ('SAME', 'VALID' or [(lo, hi), (lo, hi)]) as explicit
    ((top, bottom), (left, right))."""
    if padding == 'VALID':
        return (0, 0), (0, 0)
    if padding == 'SAME':
        return same_pads(h, kh, stride), same_pads(w, kw, stride)
    (pt, pb), (pl, pr) = padding
    return (pt, pb), (pl, pr)


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


# --------------------------------------------------------------------------
# Phase ops
# --------------------------------------------------------------------------

class F32Ops:
    """Float twin of the model on folded params: conv -> +bias -> ReLU;
    dense likewise. `flat` holds device tensors: conv kernels as OIHW,
    dense kernels as [in, out]."""

    def __init__(self, flat, mean_pixel=None):
        self.flat = flat
        self.mean_pixel = mean_pixel

    def _mold_maybe(self, x):
        """uint8 input = raw pixels: subtract the mean here (the serving
        host ships 1 byte a pixel); float input = already molded."""
        if x.dtype == torch.uint8:
            mean = torch.tensor(np.asarray(self.mean_pixel, np.float32),
                                device=x.device)
            return x.to(torch.float32) - mean
        return x

    def input(self, x):
        return self._mold_maybe(x).to(torch.float32)

    def conv(self, x, site, stride=1, padding='SAME'):
        w, b = self.flat[site]
        (pt, pb), (pl, pr) = _pads(padding, x.shape[1], x.shape[2],
                                   w.shape[2], w.shape[3], stride)
        xc = _nchw(x)
        if pt or pb or pl or pr:
            xc = F.pad(xc, (pl, pr, pt, pb))
        return _nhwc(F.conv2d(xc, w, stride=stride)) + b

    def dense(self, x, site):
        w, b = self.flat[site]
        return x @ w + b

    def dense_final(self, x, site):
        return self.dense(x, site)

    def relu(self, x, site=None):
        return torch.relu(x)

    def requant(self, x, site):
        return x

    def add(self, a, b):
        return a + b

    def join(self, r, sc, site):
        return self.relu(self.add(r, sc), site)

    def maxpool(self, x):
        xc = _nchw(x)
        (pt, pb), (pl, pr) = (same_pads(xc.shape[2], 3, 2),
                              same_pads(xc.shape[3], 3, 2))
        xc = F.pad(xc, (pl, pr, pt, pb), value=float('-inf'))
        return _nhwc(F.max_pool2d(xc, 3, 2))

    def flatten(self, x, site):
        return x.reshape(x.shape[0], -1)

    def finalize(self, out):
        return {k: v.to(torch.float32) for k, v in out.items()}


class CalibOps(F32Ops):
    """F32 twin that also records max|x| at every quantize site, and the
    per-channel max (over batch and space) that smooth() migrates."""

    def __init__(self, flat, mean_pixel=None):
        super().__init__(flat, mean_pixel)
        self.maxabs: Dict[str, torch.Tensor] = {}
        self.chan_max: Dict[str, torch.Tensor] = {}

    def _observe(self, name, x, per_channel=True):
        a = torch.abs(x.to(torch.float32))
        self.maxabs[name] = torch.amax(a)
        if per_channel:
            self.chan_max[name] = torch.amax(a, dim=tuple(range(a.dim() - 1)))
        return x

    def input(self, x):
        return self._observe('input', super().input(x), per_channel=False)

    def relu(self, x, site=None):
        y = super().relu(x)
        if site:
            self._observe(site, y)
        return y

    def requant(self, x, site):
        return self._observe(site, x)

    def flatten(self, x, site):
        # per conv-output-channel statistics: the last axis before the
        # flatten
        self._observe(site, x)
        return x.reshape(x.shape[0], -1)

    def join(self, r, sc, site):
        return self._observe(site, torch.relu(r + sc))


class _QT:
    """A quantized activation: int8 tensor + its dequantization scale
    (a Python float, the step s = scale_site / 127)."""

    __slots__ = ('arr', 'scale')

    def __init__(self, arr, scale):
        self.arr, self.scale = arr, scale


class _Pending:
    """An int8 conv or dense whose epilogue its consumer picks."""

    __slots__ = ('x', 'site', 'stride', 'padding')

    def __init__(self, x, site, stride=1, padding=None):
        self.x, self.site, self.stride, self.padding = x, site, stride, padding


class Int8Ops:
    """int8 serving phase. Activations travel as _QT (int8 + step);
    convs and denses resolve in their consumer's fused epilogue. The
    final float denses (dense_final) run as plain f32 matmuls.

    q: {site: (w8 in the kernels' layout, sw f32 [N] tensor, bias f32 [N]
    tensor)}; ffinal: {site: (w [in,out] f32, b)} for the float finals;
    alphas: a dict shared across calls that caches sw * f32(s_in) per
    (site, s_in). plain=True computes the products with the kernels'
    plain versions (float64 accumulation) on any device."""

    def __init__(self, q, ffinal, act_scales, mean_pixel=None,
                 alphas=None, plain=False):
        self.q = q
        self.ffinal = ffinal
        self.mean_pixel = mean_pixel
        # a site whose calibration batch gave all-zero activations must
        # not divide by 0
        self.scales = {k: max(float(v), 1e-10) for k, v in act_scales.items()}
        self.alphas = {} if alphas is None else alphas
        self._gemm = int8_cuda.gemm_s8_torch if plain else int8_cuda.gemm_s8
        self._conv = int8_cuda.conv_s8_torch if plain else int8_cuda.conv_s8

    def _step(self, site):
        return self.scales[site] / 127.0

    @staticmethod
    def _inv(step):
        """f32(1 / f32(step)): what XLA multiplies by for `x / step`."""
        return float(np.float32(1.0) / np.float32(step))

    def _q8(self, x, site):
        s = self._step(site)
        inv = torch.tensor(self._inv(s), dtype=torch.float32, device=x.device)
        y = torch.clamp(torch.round(x.to(torch.float32) * inv), -127, 127)
        return _QT(y.to(torch.int8), s)

    def _alpha(self, site, s_in, dev):
        key = (site, s_in)
        if key not in self.alphas:
            sw = self.q[site][1]
            self.alphas[key] = (sw * torch.tensor(np.float32(s_in),
                                                  device=sw.device)
                                ).to(dev).contiguous()
        return self.alphas[key]

    def _run(self, p: _Pending, epilogue, out_site=None, res=None):
        """Resolve a pending product with `epilogue`; the int8 modes
        requantize onto `out_site`'s step."""
        x = p.x
        w8, _, b = self.q[p.site]
        alpha = self._alpha(p.site, x.scale, x.arr.device)
        kw = dict(alpha=alpha, beta=b)
        step = None
        if out_site is not None:
            step = self._step(out_site)
            kw['inv_s_out'] = self._inv(step)
        if res is not None:
            kw.update(res=res.arr, res_scale=float(np.float32(res.scale)))
        if p.padding is None:  # dense
            out = self._gemm(x.arr, w8, epilogue, **kw)
        else:
            kh, kwd = w8.shape[0], w8.shape[1]
            arr = x.arr
            pads = _pads(p.padding, arr.shape[1], arr.shape[2], kh, kwd,
                         p.stride)
            if kh == 1 and kwd == 1 and pads == ((0, 0), (0, 0)):
                # 1x1 conv = GEMM over the (strided) pixels
                if p.stride > 1:
                    arr = arr[:, ::p.stride, ::p.stride, :].contiguous()
                bsz, h, w, c = arr.shape
                if res is not None:
                    kw['res'] = kw['res'].reshape(-1, kw['res'].shape[-1])
                out = self._gemm(arr.reshape(-1, c), w8.reshape(c, -1),
                                 epilogue, **kw).reshape(bsz, h, w, -1)
            else:
                out = self._conv(arr, w8, p.stride, pads, epilogue, **kw)
        return _QT(out, step) if step is not None else out

    def input(self, x):
        return self._q8(F32Ops._mold_maybe(self, x), 'input')

    def conv(self, x, site, stride=1, padding='SAME'):
        return _Pending(x, site, stride, padding)

    def dense(self, x, site):
        return _Pending(x, site)

    def dense_final(self, x, site):
        """Float final dense (accuracy-critical, compute-trivial)."""
        x = self._float(x)
        w, b = self.ffinal[site]
        return x @ w + b

    def _float(self, x):
        return self.dequant(x) if isinstance(x, _QT) else x

    def relu(self, x, site=None):
        if isinstance(x, _Pending):
            if site:
                return self._run(x, 'q8_relu', site)
            return self._run(x, 'f32_relu')
        return torch.relu(self._float(x))  # after a float dense_final

    def requant(self, x, site):
        if site not in self.scales:
            raise NotImplementedError(
                f'artifact without the shortcut requant site {site!r}: the '
                'float residual join is not ported')
        return self._run(x, 'q8', site)

    def join(self, r, sc, site):
        # r: the pending 2c conv; sc: the int8 shortcut
        return self._run(r, 'join', site, res=sc)

    def maxpool(self, x):
        """3x3/2 SAME max over int8 (monotone, so it commutes with the
        quantization), padded with -128; through an exact float view
        because CUDA's max_pool2d takes no int8."""
        ft = torch.float16 if x.arr.is_cuda else torch.float32
        xc = _nchw(x.arr).to(ft)
        (pt, pb), (pl, pr) = (same_pads(xc.shape[2], 3, 2),
                              same_pads(xc.shape[3], 3, 2))
        xc = F.pad(xc, (pl, pr, pt, pb), value=-128.0)
        y = _nhwc(F.max_pool2d(xc, 3, 2)).to(torch.int8).contiguous()
        return _QT(y, x.scale)

    def dequant(self, x):
        return x.arr.to(torch.float32) * torch.tensor(
            np.float32(x.scale), device=x.arr.device)

    def flatten(self, x, site):
        # x: the pending bottleneck conv
        y = self._run(x, 'q8', site)
        return _QT(y.arr.reshape(y.arr.shape[0], -1), y.scale)

    def finalize(self, out):
        return {k: self._float(v).to(torch.float32) for k, v in out.items()}


def float_sites(mcfg) -> set:
    """Sites that run in FLOAT at serving time: the regression /
    quaternion / keypoint finals, plus the hidden denses of metric
    regression heads under float_reg_head, and the classification finals
    under float_cls_final."""
    frh = mcfg.get('float_reg_head', False)

    def hidden(prefix):
        return {f'{prefix}_head/{prefix}_dense_{i}'
                for i in range(mcfg['nr_dense_layers'])} if frh else set()

    if mcfg['regress_keypoints']:
        return {'loc_head/k1_final', 'loc_head/k2_final',
                'loc_head/k3_final'} | hidden('loc')
    sites = set()
    if mcfg['regress_loc']:
        sites.add('loc_head/loc_final')
        sites |= hidden('loc')
    elif mcfg.get('float_cls_final'):
        sites.add('loc_head/loc_final')
    if mcfg['regress_ori']:
        sites.add('ori_head/ori_q'
                  if mcfg['orientation_param'] == 'quaternion'
                  else 'ori_head/ori_final')
        sites |= hidden('ori')
    elif mcfg.get('float_cls_final'):
        sites.add('ori_head/ori_final')
    return sites


def migration_groups(mcfg) -> list:
    """Channel-space groups for SmoothQuant-style scale migration: each
    names the activation site(s) sharing one channel space, the sites
    producing into it (output channels scale by 1/m) and the sites
    consuming it (input channels absorb m). Consumer kinds: 'conv' (HWIO,
    input axis -2), 'dense' (input axis 0), 'dense_flat' (dense over
    flattened NHWC features)."""
    groups = []

    def grp(acts, producers, consumers):
        groups.append(dict(acts=list(acts), producers=list(producers),
                           consumers=list(consumers)))

    arch = mcfg['backbone']
    if arch in ('resnet50', 'resnet101'):
        n4 = {'resnet50': 5, 'resnet101': 22}[arch]
        stages = [(2, ['a', 'b', 'c']),
                  (3, ['a', 'b', 'c', 'd']),
                  (4, ['a'] + [chr(98 + i) for i in range(n4)]),
                  (5, ['a', 'b', 'c'])]
        grp(['conv1/out'], ['conv1'],
            [('res2a_branch2a', 'conv'), ('res2a_branch1', 'conv')])
        for si, (s, blocks) in enumerate(stages):
            stream_acts, stream_prod, stream_cons = [], [], []
            for b in blocks:
                c = f'res{s}{b}_branch'
                grp([c + '2a/out'], [c + '2a'], [(c + '2b', 'conv')])
                grp([c + '2b/out'], [c + '2b'], [(c + '2c', 'conv')])
                stream_prod.append(c + '2c')
                stream_acts.append(c + '/out')
                if b != 'a':
                    stream_cons.append((c + '2a', 'conv'))
            stream_prod.append(f'res{s}a_branch1')
            stream_acts.append(f'res{s}a_branch1/out')
            if si + 1 < len(stages):
                nxt = stages[si + 1][0]
                stream_cons += [(f'res{nxt}a_branch2a', 'conv'),
                                (f'res{nxt}a_branch1', 'conv')]
            else:
                stream_cons.append(('bottleneck_layer', 'conv'))
            grp(stream_acts, stream_prod, stream_cons)
    else:
        reps = [2, 2, 2, 2] if arch == 'resnet18' else [3, 4, 6, 3]
        grp(['conv0/out'], ['conv0'],
            [('stage1_unit1_conv1', 'conv'), ('stage1_unit1_sc', 'conv')])
        for stage, rep in enumerate(reps):
            stream_acts, stream_prod, stream_cons = [], [], []
            for blk in range(rep):
                base = f'stage{stage + 1}_unit{blk + 1}_'
                grp([base + 'conv1/out'], [base + 'conv1'],
                    [(base + 'conv2', 'conv')])
                stream_prod.append(base + 'conv2')
                stream_acts.append(base + '/out')
                if blk > 0:
                    stream_cons.append((base + 'conv1', 'conv'))
            first = f'stage{stage + 1}_unit1_'
            stream_prod.append(first + 'sc')
            stream_acts.append(first + 'sc/out')
            if stage + 1 < len(reps):
                nxt = f'stage{stage + 2}_unit1_'
                stream_cons += [(nxt + 'conv1', 'conv'), (nxt + 'sc', 'conv')]
            else:
                stream_cons.append(('bottleneck_layer', 'conv'))
            grp(stream_acts, stream_prod, stream_cons)

    head_prefixes = ['loc'] if mcfg['regress_keypoints'] else ['loc', 'ori']
    grp(['bottleneck/out'], ['bottleneck_layer'],
        [(f'{p}_head/{p}_dense_0', 'dense_flat') for p in head_prefixes])

    fsites = float_sites(mcfg)
    n = mcfg['nr_dense_layers']
    for p in head_prefixes:
        finals = {'loc': ('loc_head/k1_final' if mcfg['regress_keypoints']
                          else 'loc_head/loc_final'),
                  'ori': ('ori_head/ori_q'
                          if mcfg['regress_ori']
                          and mcfg['orientation_param'] == 'quaternion'
                          else 'ori_head/ori_final')}[p]
        for i in range(n):
            site = f'{p}_head/{p}_dense_{i}'
            nxt = f'{p}_head/{p}_dense_{i + 1}' if i < n - 1 else finals
            if i == n - 1 and nxt in fsites:
                continue  # float final: last hidden relu isn't quantized
            grp([site + '/out'], [site], [(nxt, 'dense')])
    return groups


# --------------------------------------------------------------------------
# The twin graph (mirrors the model exactly)
# --------------------------------------------------------------------------

def _bottleneck_backbone(ops, x, architecture):
    """ResNet-50/101; the stem is the 7x7/2 conv with (3,3) pads."""
    y = ops.conv(x, 'conv1', 2, [(3, 3), (3, 3)])
    y = ops.relu(y, 'conv1/out')
    y = ops.maxpool(y)

    def block(y, stage, blk, strides, conv_shortcut):
        c = f'res{stage}{blk}_branch'
        sc = ops.requant(ops.conv(y, c + '1', strides, 'VALID'),
                         c + '1/out') if conv_shortcut else y
        r = ops.conv(y, c + '2a', strides, 'VALID')
        r = ops.relu(r, c + '2a/out')
        r = ops.conv(r, c + '2b', 1, 'SAME')
        r = ops.relu(r, c + '2b/out')
        r = ops.conv(r, c + '2c', 1, 'VALID')
        return ops.join(r, sc, c + '/out')

    y = block(y, 2, 'a', 1, True)
    y = block(y, 2, 'b', 1, False)
    y = block(y, 2, 'c', 1, False)
    y = block(y, 3, 'a', 2, True)
    for b in 'bcd':
        y = block(y, 3, b, 1, False)
    y = block(y, 4, 'a', 2, True)
    n4 = {'resnet50': 5, 'resnet101': 22}[architecture]
    for i in range(n4):
        y = block(y, 4, chr(98 + i), 1, False)
    y = block(y, 5, 'a', 2, True)
    y = block(y, 5, 'b', 1, False)
    y = block(y, 5, 'c', 1, False)
    return y


def _l2norm(x):
    """tf.nn.l2_normalize semantics."""
    x = x.to(torch.float32)
    sq = torch.sum(torch.square(x), dim=-1, keepdim=True)
    return x * torch.rsqrt(torch.clamp_min(sq, 1e-12))


def twin_forward(ops, images, mcfg: dict) -> Dict[str, torch.Tensor]:
    """The graph shared by all phases; `mcfg` is the model-config
    snapshot (QuantizedModel._mcfg)."""
    x = ops.input(images)
    y = _bottleneck_backbone(ops, x, mcfg['backbone'])
    y = ops.conv(y, 'bottleneck_layer', 2, 'SAME')
    feats = ops.flatten(y, 'bottleneck/out')

    def dense_stack(prefix, quant_last, float_hidden=False):
        h = feats
        n = mcfg['nr_dense_layers']
        for i in range(n):
            site = f'{prefix}_head/{prefix}_dense_{i}'
            if float_hidden:
                h = ops.relu(ops.dense_final(h, site))
                continue
            h = ops.dense(h, site)
            keep_q = quant_last or i < n - 1
            h = ops.relu(h, site + '/out' if keep_q else None)
        return h

    def head(prefix, final_site, final_act):
        quant_final = (final_act == 'relu'
                       and not mcfg.get('float_cls_final'))
        float_head = (final_act != 'relu'
                      and mcfg.get('float_reg_head', False))
        h = dense_stack(prefix, quant_final, float_hidden=float_head)
        site = f'{prefix}_head/{final_site}'
        h = ops.dense(h, site) if quant_final else ops.dense_final(h, site)
        if final_act == 'relu':
            h = ops.relu(h)
        elif final_act == 'l2norm':
            h = _l2norm(h)
        return h

    out: Dict[str, torch.Tensor] = {}
    if mcfg['regress_keypoints']:
        h = dense_stack('loc', quant_last=False,
                        float_hidden=mcfg.get('float_reg_head', False))
        out['loc'] = ops.dense_final(h, 'loc_head/k1_final')
        out['k1'] = ops.dense_final(h, 'loc_head/k2_final')
        out['k2'] = ops.dense_final(h, 'loc_head/k3_final')
        return ops.finalize(out)

    out['loc'] = head('loc', 'loc_final',
                      'linear' if mcfg['regress_loc'] else 'relu')
    if mcfg['regress_ori']:
        if mcfg['orientation_param'] == 'quaternion':
            out['ori'] = head('ori', 'ori_q', 'l2norm')
        else:
            out['ori'] = head('ori', 'ori_final', 'linear')
    else:
        out['ori'] = head('ori', 'ori_final', 'relu')
    return ops.finalize(out)


# --------------------------------------------------------------------------
# Public facade
# --------------------------------------------------------------------------

_UNPORTED_KNOBS = (('QUANT_STEM_S2D', 'the space-to-depth stem'),
                   ('QUANT_HOST_S2D', 'host space-to-depth input'),
                   ('QUANT_BF16_STEM', 'the bf16 stem'),
                   ('QUANT_S8_JOIN', 'integer residual joins'),
                   ('F16', 'bf16 epilogues (F16)'))


class QuantizedModel:
    """Calibrated int8 serving model on `device` (default the card).

    from_variables() folds BN and flattens the weights; calibrate() runs
    the float twin once to set the activation scales; __call__ is the
    int8 forward. float_twin() is the f32 reference twin."""

    def __init__(self, config, flat_params, device='cuda'):
        self.device = resolve_device(device)
        for knob, what in _UNPORTED_KNOBS:
            if getattr(config, knob, False):
                raise NotImplementedError(
                    f'{knob}: {what} is not ported to the int8 path')
        if config.BACKBONE not in ('resnet50', 'resnet101'):
            raise NotImplementedError(
                f'backbone {config.BACKBONE!r}: the ResNet-18/34 twin is not '
                'ported')
        self.flat = flat_params
        stem = 'conv1'
        if self.flat[stem][0].shape[0] != 7:
            raise NotImplementedError('an s2d stem kernel is not ported')
        self._mcfg = dict(
            backbone=config.BACKBONE,
            nr_dense_layers=config.NR_DENSE_LAYERS,
            regress_loc=config.REGRESS_LOC,
            regress_ori=config.REGRESS_ORI,
            regress_keypoints=config.REGRESS_KEYPOINTS,
            orientation_param=config.ORIENTATION_PARAM,
            loc_bins=config.LOC_BINS_PER_DIM,
            ori_bins=config.ORI_BINS_PER_DIM,
            stem_s2d=False,
            host_s2d=False,
            bf16_stem=False,
            s8_join=False,
            float_cls_final=bool(getattr(config, 'QUANT_FLOAT_CLS_FINAL',
                                         False)),
            float_reg_head=bool(getattr(config, 'QUANT_FLOAT_REG_HEAD',
                                        False)),
            mean_pixel=tuple(float(v) for v in config.MEAN_PIXEL),
        )
        self.act_scales: Optional[Dict[str, float]] = None
        self.chan_max: Optional[Dict[str, np.ndarray]] = None
        # additive int8-path bias corrections (from an artifact); applied
        # to the int8 weights only, never to the float twin
        self.bias_delta: Dict[str, np.ndarray] = {}
        self._flat_dev = None
        self._q_dev = None
        self._alphas: dict = {}

    @classmethod
    def from_variables(cls, config, params, batch_stats, device='cuda'):
        """params / batch_stats: nested dicts of numpy arrays in the JAX
        layout (`checkpoint/convert.py::params_to_jax_layout` of the
        port's model)."""
        return cls(config, flatten_folded(params, batch_stats, config),
                   device)

    def shard_over(self, mesh):
        raise NotImplementedError('data-parallel int8 serving is not ported')

    def bias_correct(self, images, passes: int = 1):
        raise NotImplementedError('bias_correct is not ported (artifacts '
                                  'that carry bias_delta serve it)')

    def _reset(self):
        self._flat_dev = None
        self._q_dev = None
        self._alphas = {}

    def _images(self, images):
        x = images if isinstance(images, torch.Tensor) \
            else torch.from_numpy(np.ascontiguousarray(images))
        return x.to(self.device)

    def _flat_f32(self):
        """Device copy of the float weights: conv kernels OIHW
        (channels-last on the card), dense kernels [in, out]."""
        if self._flat_dev is None:
            fmt = torch.channels_last if self.device.type == 'cuda' \
                else torch.contiguous_format
            dev = {}
            for s, (w, b) in self.flat.items():
                w = torch.from_numpy(np.asarray(w, np.float32))
                if w.dim() == 4:
                    w = w.permute(3, 2, 0, 1).contiguous(memory_format=fmt)
                dev[s] = (w.to(self.device),
                          torch.from_numpy(np.asarray(b, np.float32))
                          .to(self.device))
            self._flat_dev = dev
        return self._flat_dev

    def float_twin(self, images):
        with no_tf32(), torch.no_grad():
            return twin_forward(
                F32Ops(self._flat_f32(), self._mcfg['mean_pixel']),
                self._images(images), self._mcfg)

    def calibrate(self, images, percentile_headroom: float = 1.0):
        """Max-abs calibration over one molded (float) or raw (uint8)
        batch; call again to take the running max across batches."""
        with no_tf32(), torch.no_grad():
            ops = CalibOps(self._flat_f32(), self._mcfg['mean_pixel'])
            twin_forward(ops, self._images(images), self._mcfg)
        maxabs = {k: float(v) * percentile_headroom
                  for k, v in ops.maxabs.items()}
        chan_max = {k: v.cpu().numpy() * percentile_headroom
                    for k, v in ops.chan_max.items()}
        if self.act_scales is None:
            self.act_scales = maxabs
            self.chan_max = chan_max
        else:
            self.act_scales = {k: max(self.act_scales[k], v)
                               for k, v in maxabs.items()}
            self.chan_max = {k: np.maximum(self.chan_max[k], v)
                             for k, v in chan_max.items()}
        self._q_dev = None
        self._alphas = {}
        return self.act_scales

    def smooth(self, alpha: float = 0.5, max_spread: float = None):
        """SmoothQuant-style scale migration (numpy, as the JAX package):
        for every producer->consumer channel space, m_c = a_c^alpha /
        w_c^(1-alpha) divides the producers' output channels and
        multiplies the consumers' input channels (exact in float), and the
        per-tensor activation scales follow analytically. Requires
        calibrate(). Returns {group: channel spread}."""
        if self.chan_max is None:
            raise RuntimeError('calibrate() before smooth()')
        flat = {s: (np.array(w, np.float32, copy=True),
                    np.array(b, np.float32, copy=True))
                for s, (w, b) in self.flat.items()}
        report = {}
        for g in migration_groups(self._mcfg):
            if not all(a in self.chan_max for a in g['acts']):
                continue
            if not all(p in flat for p in g['producers']):
                continue
            if not all(c in flat for c, _ in g['consumers']):
                continue
            a = np.maximum.reduce([np.asarray(self.chan_max[s], np.float32)
                                   for s in g['acts']])
            C = a.shape[0]
            ws = []
            for site, kind in g['consumers']:
                k = flat[site][0]
                if kind == 'conv':
                    ws.append(np.abs(k).max(axis=(0, 1, 3)))
                elif kind == 'dense':
                    ws.append(np.abs(k).max(axis=1))
                else:  # dense_flat: rows group as (h*w, C)
                    ws.append(np.abs(k.reshape(-1, C, k.shape[-1]))
                              .max(axis=(0, 2)))
            w = np.maximum.reduce(ws)
            m = np.where(a > 0,
                         a ** alpha / np.maximum(w, 1e-12) ** (1 - alpha),
                         1.0)
            m = np.where(np.isfinite(m), np.clip(m, 1e-4, 1e4), 1.0) \
                .astype(np.float32)
            if max_spread is not None and m.max() > 0:
                gm = np.exp(np.mean(np.log(np.maximum(m, 1e-12))))
                lim = float(np.sqrt(max_spread))
                m = np.clip(m, gm / lim, gm * lim).astype(np.float32)
            for p in g['producers']:
                k, b = flat[p]
                flat[p] = (k / m, b / m)  # output axis is last everywhere
            for site, kind in g['consumers']:
                k, b = flat[site]
                if kind == 'conv':
                    k = k * m[None, None, :, None]
                elif kind == 'dense':
                    k = k * m[:, None]
                else:
                    k = (k.reshape(-1, C, k.shape[-1])
                         * m[None, :, None]).reshape(k.shape)
                flat[site] = (k, b)
            for s in g['acts']:
                cm = np.asarray(self.chan_max[s], np.float32) / m
                self.chan_max[s] = cm
                self.act_scales[s] = float(cm.max())
            report[g['acts'][0]] = float(m.max() / max(m.min(), 1e-12))
        self.flat = flat
        self._reset()
        return report

    def _prepared_q(self):
        """Device int8 weight tree {site: (w8 in the kernels' layout, sw,
        bias + bias_delta)}; the float sites keep their f32 kernels."""
        if self._q_dev is None:
            fsites = float_sites(self._mcfg)
            q = {}
            for site, (w, b) in self.flat.items():
                if site in fsites:
                    continue
                w8, sw = quantize_weight(w)
                b = np.asarray(b, np.float32)
                if site in self.bias_delta:
                    b = b + np.asarray(self.bias_delta[site], np.float32)
                q[site] = (int8_cuda.kernel_layout(w8).to(self.device),
                           torch.from_numpy(sw).to(self.device),
                           torch.from_numpy(np.ascontiguousarray(b))
                           .to(self.device))
            self._q_dev = q
        return self._q_dev

    def __call__(self, images, plain: bool = False):
        """int8 forward of a molded (float) or raw (uint8) [B,H,W,3]
        batch. plain=True runs the kernels' plain PyTorch versions
        (float64 accumulation) instead of the kernels, on any device: the
        reference the kernels are held against."""
        if self.act_scales is None:
            raise RuntimeError('calibrate() before inference')
        flat_dev = self._flat_f32()
        ffinal = {s: flat_dev[s] for s in float_sites(self._mcfg)
                  if s in flat_dev}
        ops = Int8Ops(self._prepared_q(), ffinal, self.act_scales,
                      mean_pixel=self._mcfg['mean_pixel'],
                      alphas=self._alphas, plain=plain)
        with no_tf32(), torch.no_grad():
            return twin_forward(ops, self._images(images), self._mcfg)
