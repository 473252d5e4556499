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

On the card, `Int8Ops` computes every int8 product through the
hand-written kernels of `ops/int8_cuda.py`: `stem_s8` for the whole stem
section of a uint8 batch, `conv_s8` for the stem of a float molded batch,
the 3x3 convs and the 3x3/2 bottleneck conv, `gemm_s8` for the 1x1 convs
and the int8 head denses. A conv or dense returns a pending product that
its consumer (ReLU + requantize, shortcut requantize, residual join,
flatten) resolves with the matching fused epilogue, so no s32
accumulator or float activation is written between two int8 sites. The
maxpool and the input quantize of the unfused stem, the float final
denses and the bf16 stem's conv stay plain PyTorch ops, as they were XLA
ops in the JAX package.

The stem dispatches on the input's type and shape, before any launch: a
uint8 batch runs the whole stem section (input quantize, conv, ReLU +
requantize, maxpool) as one launch of `stem_s8`. The raw batch [B,H,W,3]
(H even, W % 16 == 0: `int8_cuda.stem_route`) takes its 'nhwc' route in
the `base` and `s2d` variants alike, with the stem kernel's (4,4,12,64)
space-to-depth form (the 7x7 kernel's exact rewrite, made once in
`QuantizedModel._prepared_q`); packed pixels (QUANT_HOST_S2D) take its
'tma' route, and a raw batch of another shape is packed on the device
first under QUANT_STEM_S2D. A float molded batch, a capture pass and a
raw batch the routes do not take under `base` run input quantize ->
`conv_s8` -> maxpool. All give the same bits.

Under F16 (`acc_dtype` bfloat16, as the JAX package sets it from the
config) every epilogue runs in the kernels' bf16 mode
(`ops/int8_cuda.py`), the dequantize and the float final denses in
bf16, and the head outputs are widened to f32; the float twin, the
calibration and the input quantize stay f32, as in the JAX package.

`bias_correct` measures each site's per-channel mean error against the
float twin on the calibration batch and corrects the int8 biases one
site at a time in graph order, as the JAX package does.

ResNet-18/34 (`_basic_backbone`): the 'conv0' stem, and per basic block
the 1x1/s shortcut 'sc' requantized onto 'sc/out' (a GEMM over the
strided pixels), conv1 (3x3/s, (1,1) pads) with ReLU + requantize, and
conv2 (3x3/1) resolved in the residual join's epilogue on `conv_s8`.
QUANT_STEM_S2D rewrites 'conv0' as it rewrites 'conv1'.

The serving knobs of the JAX package: QUANT_S8_JOIN resolves each
residual join in `join_s8`, the integer join of both operands rounded
onto the output grid; QUANT_BF16_STEM molds the pixels into bf16 and
runs the stem conv on them and the stored int8 kernel with f32
accumulation, in PyTorch as the JAX package runs it in XLA (the fused
stem and the int8 input quantize do not run then). An artifact calibrated
before the shortcut requant sites existed serves its shortcut convs in
float ('f32' epilogue, 'f32_sum' under QUANT_S8_JOIN) and joins them as
a float residual.

`shard_over(mesh)` serves data-parallel over a mesh's 'data' axis: each
data rank runs its rows of the batch through the kernels with the
weights and scales replicated (no collective in the int8 body), and the
outputs are gathered over 'data' (on the card under NCCL, on the host
under gloo).

Usage:
    qm = QuantizedModel.from_variables(config, params, batch_stats)
    qm.calibrate(molded_images)            # one representative batch
    qm.smooth(0.5)                         # optional
    qm.bias_correct(molded_images)         # optional
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
from ursonet_torch.models.resnet import SHALLOW_REPS, same_pads, \
    space_to_depth2, stem_kernel_to_s2d
from ursonet_torch.ops import int8_cuda
from ursonet_torch.utils.profiling import span
from ursonet_torch.utils.staging import to_device

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
    part of the site bias. As the JAX gate reads it, TRAIN_BN=None (a
    model whose running statistics trained) folds and serves; True (a BN
    after each hidden head dense, which the twin graph has no site for)
    raises."""
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

def _mean_for(mean_pixel, channels: int) -> np.ndarray:
    """The f32 pixel mean per input channel; for a space-to-depth input
    ([B,H/2,W/2,4C], channel order (dy,dx,c)) tiled over the four
    phases."""
    mean = np.asarray(mean_pixel, np.float32)
    return np.tile(mean, 4) if channels == 4 * mean.shape[0] else mean


def _capture_mean(capture, site, y):
    """Record the per-channel mean of the pre-activation `y` (over every
    axis but the last) when `capture` is a dict (bias_correct)."""
    if capture is not None:
        y = y.to(torch.float32)
        capture[site] = torch.mean(y, dim=tuple(range(y.dim() - 1)))


class F32Ops:
    """Float twin of the model on folded params: conv -> +bias -> ReLU;
    dense likewise. `flat` holds device tensors: conv kernels as OIHW,
    dense kernels as [in, out]. When `capture` is a dict, conv and dense
    record their per-channel output mean there (bias_correct)."""

    def __init__(self, flat, mean_pixel=None):
        self.flat = flat
        self.mean_pixel = mean_pixel
        self.capture: Optional[Dict[str, torch.Tensor]] = None

    def _mold_maybe(self, x):
        """uint8 input = raw pixels: subtract the mean here (the serving
        host ships 1 byte a pixel); float input = already molded."""
        if x.dtype == torch.uint8:
            return x.to(torch.float32) - torch.tensor(
                _mean_for(self.mean_pixel, x.shape[-1]), device=x.device)
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
        y = _nhwc(F.conv2d(xc, w, stride=stride)) + b
        _capture_mean(self.capture, site, y)
        return y

    def dense(self, x, site):
        w, b = self.flat[site]
        y = x @ w + b
        _capture_mean(self.capture, site, y)
        return y

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


class _U8(_QT):
    """Raw uint8 pixels on their way to the fused stem (no scale yet:
    stem_s8 quantizes them as it stages them)."""

    __slots__ = ()

    def __init__(self, arr, scale=None):
        super().__init__(arr, scale)


class _Pending:
    """An int8 conv or dense whose epilogue its consumer picks."""

    __slots__ = ('x', 'site', 'stride', 'padding')

    def __init__(self, x, site, stride=1, padding=None):
        self.x, self.site, self.stride, self.padding = x, site, stride, padding


class _U8NHWC(_U8):
    """The raw uint8 batch [B,H,W,3] on its way to the fused stem's
    'nhwc' route: neither packed nor quantized before it."""

    __slots__ = ()


class _PendingStem:
    """The s2d stem conv over raw uint8 pixels with its ReLU + requantize
    site, waiting for the maxpool that launches the fused stem."""

    __slots__ = ('x', 'site', 'out_site')

    def __init__(self, x, site, out_site):
        self.x, self.site, self.out_site = x, site, out_site


class Int8Ops:
    """int8 serving phase. Activations travel as _QT (int8 + step);
    convs and denses resolve in their consumer's fused epilogue. The
    final float denses (dense_final) run as plain matmuls.

    q: {site: (w8 in the kernels' layout, sw f32 [N] tensor, bias f32 [N]
    tensor)}; ffinal: {site: (w [in,out] f32, b)} for the float finals;
    alphas: a dict shared across calls that caches sw * f32(s_in) per
    (site, s_in). acc_dtype: the epilogues' accumulation mode, f32 or
    bf16 (F16: the kernels' bf16 mode, and the dequantize and the float
    finals in bf16). plain=True computes the products with the kernels'
    plain versions (float64 accumulation) on any device. fused_stem: the
    stem kernel is in s2d form, so a packed uint8 batch takes `stem_s8`
    (and a raw one of a shape its 'nhwc' route does not take is packed on
    the device first). A raw uint8 batch [B,H,W,3] that the 'nhwc' route
    takes goes to `stem_s8` whatever the kernel's form: `stem_w4` caches
    {site: the s2d form of a 7x7 stem kernel} (made here where it is
    missing).

    bf16_stem (QUANT_BF16_STEM): the input is molded into bf16 pixels
    and the stem conv is a float conv (f32 accumulation) over them and
    the stored int8 kernel, `acc * sw + b` in f32, requantized by its
    ReLU. s8_join (QUANT_S8_JOIN): each join whose site is calibrated is
    the kernels' `join_s8`.

    When `capture` is a dict (bias_correct), every product resolves to
    its s32 accumulator; the per-channel mean of its pre-activation sum
    (`int8_cuda.epilogue_sum`: under F16 the sum before its bf16
    rounding, which XLA drops where the JAX package widens the bf16
    pre-activation for the mean) is recorded, and the consumer's epilogue
    is applied to the same accumulator by the plain epilogue, which gives
    the fused kernel's bits. The fused stem is not taken then: a uint8
    batch is quantized as a molded one is."""

    def __init__(self, q, ffinal, act_scales, mean_pixel=None,
                 alphas=None, plain=False, fused_stem=False,
                 acc_dtype=torch.float32, bf16_stem=False, s8_join=False,
                 stem_w4=None):
        self.q = q
        self.plain = plain
        self.stem_w4 = {} if stem_w4 is None else stem_w4
        self.bf16_stem = bf16_stem
        self.s8_join = s8_join
        self.ffinal = ffinal
        self.mean_pixel = mean_pixel
        # a site whose calibration batch gave all-zero activations must
        # not divide by 0
        self.scales = {k: max(float(v), 1e-10) for k, v in act_scales.items()}
        self.alphas = {} if alphas is None else alphas
        self._gemm = int8_cuda.gemm_s8_torch if plain else int8_cuda.gemm_s8
        self._conv = int8_cuda.conv_s8_torch if plain else int8_cuda.conv_s8
        self._stem = int8_cuda.stem_s8_torch if plain else int8_cuda.stem_s8
        self.fused_stem = fused_stem
        self.acc_dtype = acc_dtype
        self.capture: Optional[Dict[str, torch.Tensor]] = None

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

    def _product(self, p: _Pending, epilogue, kw):
        """The pending product through `epilogue`: a GEMM for a dense or
        an unpadded 1x1 conv, else a conv."""
        x, w8 = p.x, self.q[p.site][0]
        kw = dict(kw, acc_dtype=self.acc_dtype)
        if p.padding is None:  # dense
            return self._gemm(x.arr, w8, epilogue, **kw)
        kh, kwd = w8.shape[0], w8.shape[1]
        arr = x.arr
        pads = _pads(p.padding, arr.shape[1], arr.shape[2], kh, kwd, p.stride)
        if kh == 1 and kwd == 1 and pads == ((0, 0), (0, 0)):
            # 1x1 conv = GEMM over the (strided) pixels
            if p.stride > 1:
                arr = arr[:, ::p.stride, ::p.stride, :].contiguous()
            bsz, h, w, c = arr.shape
            if 'res' in kw:
                kw['res'] = kw['res'].reshape(-1, kw['res'].shape[-1])
            return self._gemm(arr.reshape(-1, c), w8.reshape(c, -1),
                              epilogue, **kw).reshape(bsz, h, w, -1)
        return self._conv(arr, w8, p.stride, pads, epilogue, **kw)

    def _run(self, p: _Pending, epilogue, out_site=None, res=None,
             res_scale=1.0):
        """Resolve a pending product with `epilogue`; the int8 modes
        requantize onto `out_site`'s step; the joins add the residual
        tensor `res` (int8 or float) times `res_scale`."""
        _, _, b = self.q[p.site]
        alpha = self._alpha(p.site, p.x.scale, p.x.arr.device)
        kw = dict(alpha=alpha, beta=b)
        step = None
        if out_site is not None:
            step = self._step(out_site)
            kw['inv_s_out'] = self._inv(step)
        if res is not None:
            kw.update(res=res, res_scale=res_scale)
        if self.capture is None:
            out = self._product(p, epilogue, kw)
        else:
            acc = self._product(p, 's32', {})
            _capture_mean(self.capture, p.site, int8_cuda.epilogue_sum(
                acc, alpha, b, self.acc_dtype))
            out = int8_cuda.epilogue_torch(acc, epilogue,
                                           acc_dtype=self.acc_dtype, **kw)
        return _QT(out, step) if step is not None else out

    def input(self, x):
        if self.bf16_stem:
            # molded pixels in bf16 (integers up to 255 keep 8 bits)
            return F32Ops._mold_maybe(self, x).to(torch.bfloat16)
        if x.dtype == torch.uint8 and self.capture is None:
            if x.dim() == 4 and x.shape[3] == 3:
                x = x.contiguous()
                if int8_cuda.stem_route(x.shape[2], int8_cuda._aligned(x), 3,
                                        x.shape[1]) == 'nhwc':
                    return _U8NHWC(x)
            if self.fused_stem:
                return _U8(x)
        return self._q8(F32Ops._mold_maybe(self, x), 'input')

    def conv(self, x, site, stride=1, padding='SAME'):
        return _Pending(x, site, stride, padding)

    def _float_stem(self, p: _Pending) -> torch.Tensor:
        """The bf16 stem's conv: bf16 pixels times the stored int8 kernel
        (exact products) summed in f32, then acc * sw + b in f32, b
        rounded to bf16 first under F16 as JAX's b.astype(dt). The sums
        run in another order than XLA's, and the product and the sum are
        each rounded where XLA may contract them into an FMA: the bf16
        stem holds the JAX package's outputs at a tolerance."""
        w8, sw, b = self.q[p.site]
        x = p.x.to(torch.float32)
        w = w8.permute(3, 2, 0, 1).to(torch.float32)
        (pt, pb), (pl, pr) = _pads(p.padding, x.shape[1], x.shape[2],
                                   w.shape[2], w.shape[3], p.stride)
        xc = F.pad(_nchw(x), (pl, pr, pt, pb))
        acc = _nhwc(F.conv2d(xc, w, stride=p.stride))
        if self.acc_dtype == torch.bfloat16:
            b = int8_cuda.bf(b)
        y = acc * sw + b
        _capture_mean(self.capture, p.site, y)
        return y

    def _stem_kernel(self, site, s2d):
        """`site`'s stem kernel in the kernels' layout, in its s2d form
        (the fused stem's) or as the 7x7 kernel (the 'nhwc' route's plain
        version), whichever form `q` holds."""
        w8 = self.q[site][0]
        if (w8.shape[0] == 4) == s2d:
            return w8
        if not s2d:
            return int8_cuda.stem_kernel_7x7(w8)
        if site not in self.stem_w4:
            self.stem_w4[site] = int8_cuda.kernel_layout(
                stem_kernel_to_s2d(w8.cpu().numpy())).to(w8.device)
        return self.stem_w4[site]

    def _run_stem(self, p: _PendingStem):
        """One stem_s8 launch: input quantize at the 'input' step, the
        s2d conv (the 7x7/2 conv on the raw batch), q8_relu onto
        `out_site`'s step, the 3x3/2 maxpool; the 'nhwc' route's plain
        version (the 7x7 chain) where `plain`."""
        s_in, step = self._step('input'), self._step(p.out_site)
        w8, _, b = self.q[p.site]
        x = p.x.arr.contiguous()
        kw = dict(inv_s_out=self._inv(step), mode='calibrated',
                  inv_s_in=self._inv(s_in), acc_dtype=self.acc_dtype)
        alpha = self._alpha(p.site, s_in, x.device)
        if isinstance(p.x, _U8NHWC):
            mean = _mean_for(self.mean_pixel, 3)
            if self.plain:
                out = int8_cuda.stem_s8_nhwc_torch(
                    x, self._stem_kernel(p.site, False), alpha, b, mean=mean,
                    **kw)
            else:
                out = int8_cuda.stem_s8(x, self._stem_kernel(p.site, True),
                                        alpha, b, mean=mean, **kw)
        else:
            out = self._stem(x, w8, alpha, b,
                             mean=_mean_for(self.mean_pixel, 12), **kw)
        return _QT(out, step)

    def dense(self, x, site):
        return _Pending(x, site)

    def dense_final(self, x, site):
        """Float final dense (accuracy-critical, compute-trivial). Under
        F16 a bf16 product (f32 accumulation, rounded to bf16) plus the
        bf16 bias, as XLA computes `x @ bf16(w) + bf16(b)` for the JAX
        package; its f32 result is not rounded again."""
        x = self._float(x)
        w, b = self.ffinal[site]
        if self.acc_dtype == torch.bfloat16:
            dt = torch.bfloat16
            return (x.to(dt) @ w.to(dt)).to(torch.float32) \
                + b.to(dt).to(torch.float32)
        return x @ w + b

    def _float(self, x):
        return self.dequant(x) if isinstance(x, _QT) else x

    def relu(self, x, site=None):
        if isinstance(x, _Pending):
            if isinstance(x.x, _U8):
                return _PendingStem(x.x, x.site, site)
            if isinstance(x.x, torch.Tensor):     # the bf16 stem
                y = torch.relu(self._float_stem(x))
                return self._q8(y, site) if site else y
            if site:
                return self._run(x, 'q8_relu', site)
            return self._run(x, 'f32_relu')
        return torch.relu(self._float(x))  # after a float dense_final

    def requant(self, x, site):
        """The shortcut conv requantized onto `site`; for an artifact
        calibrated before that site existed, its float output, which the
        join takes as it is: the 'f32' epilogue (bf16 under F16), or under
        s8_join 'f32_sum' (f32: the sum before the bf16 rounding, which
        XLA drops where the JAX package widens it to f32 for the integer
        join)."""
        if site not in self.scales:
            return self._run(x, 'f32_sum' if self.s8_join else 'f32')
        return self._run(x, 'q8', site)

    def join(self, r, sc, site):
        """The pending 2c (conv2) conv `r` joined with the shortcut `sc`
        (int8, or float from `requant`) in the conv's epilogue: `join`
        (relu(r + sc) requantized onto `site`), or under s8_join, where
        `site` is calibrated, `join_s8` with the shortcut's ratio to the
        output step (a float shortcut: the reciprocal step)."""
        if self.s8_join and site in self.scales:
            if isinstance(sc, _QT):
                ratio = np.float32(sc.scale / self._step(site))
                return self._run(r, 'join_s8', site, sc.arr, float(ratio))
            return self._run(r, 'join_s8', site, sc,
                             self._inv(self._step(site)))
        if isinstance(sc, _QT):
            return self._run(r, 'join', site, sc.arr,
                             float(np.float32(sc.scale)))
        return self._run(r, 'join', site, sc)

    def maxpool(self, x):
        """3x3/2 SAME max over int8 (monotone, so it commutes with the
        quantization); inside the fused stem's launch where that is
        pending."""
        if isinstance(x, _PendingStem):
            return self._run_stem(x)
        return _QT(int8_cuda.maxpool_s8(x.arr), x.scale)

    def dequant(self, x):
        """int8 -> float: f32(x) * f32(step), or under F16
        bf16(bf16(x) * bf16(step))."""
        scale = torch.tensor(np.float32(x.scale), device=x.arr.device)
        if self.acc_dtype == torch.bfloat16:
            return (x.arr.to(torch.float32) * int8_cuda.bf(scale)) \
                .to(torch.bfloat16)
        return x.arr.to(torch.float32) * scale

    def flatten(self, x, site):
        # x: the pending bottleneck conv. Under F16 its bf16 output is
        # requantized after the reshape: XLA keeps that bf16 rounding
        # (the q8 epilogue's unrounded sum is what it computes where the
        # widening follows the sum directly, at the shortcut requant).
        if self.acc_dtype == torch.bfloat16:
            y = self._run(x, 'f32')
            return self._q8(y.reshape(y.shape[0], -1), site)
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
        reps = SHALLOW_REPS[arch]
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

def _stem(ops, x, mcfg, name):
    """Stem conv: 7x7/2 with (3,3) pads, or its exact space-to-depth
    rewrite when the folded kernel is in (4,4,12,O) form: 4x4/1 with
    (2,1) pads on the packed input, which the device packs here unless
    the host already did (host_s2d) or the fused stem reads the raw
    batch (Int8Ops' 'nhwc' route)."""
    if mcfg.get('stem_s2d'):
        # the raw batch of the fused stem's 'nhwc' route is packed inside
        # the kernel
        if not mcfg.get('host_s2d') and not isinstance(x, _U8NHWC):
            if isinstance(x, _QT):
                x = type(x)(space_to_depth2(x.arr), x.scale)
            else:
                x = space_to_depth2(x)
        return ops.conv(x, name, 1, [(2, 1), (2, 1)])
    return ops.conv(x, name, 2, [(3, 3), (3, 3)])


def _stem_section(ops, x, mcfg, name):
    """The stem conv, its ReLU + requantize onto '<name>/out' and the
    3x3/2 maxpool, in the span ursonet.qmodel.stem."""
    with span('ursonet.qmodel.stem'):
        return ops.maxpool(ops.relu(_stem(ops, x, mcfg, name),
                                    name + '/out'))


def _bottleneck_backbone(ops, x, mcfg):
    """ResNet-50/101: the stem section, then a span a stage."""
    architecture = mcfg['backbone']
    y = _stem_section(ops, x, mcfg, 'conv1')

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

    with span('ursonet.qmodel.res2'):
        y = block(y, 2, 'a', 1, True)
        y = block(y, 2, 'b', 1, False)
        y = block(y, 2, 'c', 1, False)
    with span('ursonet.qmodel.res3'):
        y = block(y, 3, 'a', 2, True)
        for b in 'bcd':
            y = block(y, 3, b, 1, False)
    with span('ursonet.qmodel.res4'):
        y = block(y, 4, 'a', 2, True)
        n4 = {'resnet50': 5, 'resnet101': 22}[architecture]
        for i in range(n4):
            y = block(y, 4, chr(98 + i), 1, False)
    with span('ursonet.qmodel.res5'):
        y = block(y, 5, 'a', 2, True)
        y = block(y, 5, 'b', 1, False)
        y = block(y, 5, 'c', 1, False)
    return y


def _basic_backbone(ops, x, mcfg):
    """ResNet-18/34: the 'conv0' stem section, then basic blocks (single
    BN folded into conv1; conv2 joins the shortcut raw, the join's sum
    requantized onto '<base>/out'), stage1-4 in the spans of res2-5."""
    y = _stem_section(ops, x, mcfg, 'conv0')
    reps = SHALLOW_REPS[mcfg['backbone']]
    for stage, rep in enumerate(reps):
        with span(f'ursonet.qmodel.res{stage + 2}'):
            for blk in range(rep):
                base = f'stage{stage + 1}_unit{blk + 1}_'
                strides = 2 if (blk == 0 and stage > 0) else 1
                sc = ops.requant(ops.conv(y, base + 'sc', strides, 'VALID'),
                                 base + 'sc/out') if blk == 0 else y
                r = ops.conv(y, base + 'conv1', strides, [(1, 1), (1, 1)])
                r = ops.relu(r, base + 'conv1/out')
                r = ops.conv(r, base + 'conv2', 1, [(1, 1), (1, 1)])
                y = ops.join(r, sc, base + '/out')
    return y


def _l2norm(x):
    """tf.nn.l2_normalize semantics."""
    x = x.to(torch.float32)
    sq = torch.sum(torch.square(x), dim=-1, keepdim=True)
    return x * torch.rsqrt(torch.clamp_min(sq, 1e-12))


def twin_forward(ops, images, mcfg: dict) -> Dict[str, torch.Tensor]:
    """The graph shared by all phases; `mcfg` is the model-config
    snapshot (QuantizedModel._mcfg). Spans (`utils/profiling.py`):
    ursonet.qmodel.stem, .res2 to .res5 and .head, in graph order. The
    input step runs before the stem's span: for a uint8 batch that the
    fused stem reads it launches nothing."""
    x = ops.input(images)
    if mcfg['backbone'] in SHALLOW_REPS:
        y = _basic_backbone(ops, x, mcfg)
    else:
        y = _bottleneck_backbone(ops, x, mcfg)
    with span('ursonet.qmodel.head'):
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

class QuantizedModel:
    """Calibrated int8 serving model on `device` (default the card).

    from_variables() folds BN and flattens the weights; calibrate() runs
    the float twin once to set the activation scales; __call__ is the
    int8 forward, with bf16 epilogues under config.F16 (`acc_dtype`).
    float_twin() is the f32 reference twin."""

    def __init__(self, config, flat_params, device='cuda'):
        self.device = resolve_device(device)
        self.flat = flat_params
        stem = 'conv0' if config.BACKBONE in SHALLOW_REPS else 'conv1'
        self._stem_site = stem
        if (getattr(config, 'QUANT_STEM_S2D', False)
                and self.flat[stem][0].shape[0] == 7):
            # the 7x7/2 stem rewritten exactly into its (4,4,12,O)/1
            # space-to-depth form, however the model was trained
            k, b = self.flat[stem]
            self.flat = dict(self.flat)
            self.flat[stem] = (stem_kernel_to_s2d(k), b)
        # derived from the kernel that is in `flat`, not from the knob:
        # an artifact saved after the rewrite describes itself
        stem_s2d = self.flat[stem][0].shape[0] == 4
        self._mcfg = dict(
            backbone=config.BACKBONE,
            nr_dense_layers=config.NR_DENSE_LAYERS,
            regress_loc=config.REGRESS_LOC,
            regress_ori=config.REGRESS_ORI,
            regress_keypoints=config.REGRESS_KEYPOINTS,
            orientation_param=config.ORIENTATION_PARAM,
            loc_bins=config.LOC_BINS_PER_DIM,
            ori_bins=config.ORI_BINS_PER_DIM,
            stem_s2d=stem_s2d,
            # served and calibration batches arrive packed from the host
            host_s2d=(stem_s2d
                      and bool(getattr(config, 'QUANT_HOST_S2D', False))),
            # serving ablations of the JAX package: the stem in bf16,
            # the residual joins in the integer domain
            bf16_stem=bool(getattr(config, 'QUANT_BF16_STEM', False)),
            s8_join=bool(getattr(config, 'QUANT_S8_JOIN', False)),
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
        # the epilogues' accumulation mode, as the JAX package sets it
        self.acc_dtype = torch.bfloat16 if getattr(config, 'F16', False) \
            else torch.float32
        self._flat_dev = None
        self._q_base = None
        self._q_dev = None
        # {stem site: the s2d form of its int8 7x7 kernel} (_prepared_q)
        self._stem_w4: dict = {}
        self._alphas: dict = {}
        # the data-parallel serving mesh (shard_over)
        self.mesh = None

    @classmethod
    def from_variables(cls, config, params, batch_stats, device='cuda'):
        """params / batch_stats: nested dicts of numpy arrays in the JAX
        layout (`checkpoint/convert.py::params_to_jax_layout` of the
        port's model)."""
        return cls(config, flatten_folded(params, batch_stats, config),
                   device)

    def shard_over(self, mesh):
        """Serve data-parallel over `mesh`'s 'data' axis: __call__ takes
        the global batch on every rank, runs this rank's rows (weights
        and activation scales replicated; calibration and bias
        correction stay whole-batch and replicated) and gathers the
        outputs over 'data'. The int8 body is row-exact, so the gathered
        outputs are a single rank's bits; the float final denses see
        another row count per rank, so they match to f32 rounding only.
        A mesh of one data row, or None, reverts to single-process
        serving."""
        self.mesh = mesh if (mesh is not None
                             and mesh.shape['data'] > 1) else None
        return self

    def bias_correct(self, images, passes: int = 1):
        """Calibration-set bias correction (DFQ-style, arXiv:1906.04721),
        as the JAX package's: per conv/dense output channel, the mean of
        the int8 path's pre-activation minus the float twin's on
        `images` is subtracted from the int8 bias (`bias_delta`; the
        float twin keeps its biases). Sites are corrected one at a time
        in graph order, re-measuring after each update (Gauss-Seidel: a
        correction only moves the sites downstream of it); `passes`
        sweeps. One int8 forward of `images` per quantized site and pass.
        Returns {site: max |delta|}."""
        if self.act_scales is None:
            raise RuntimeError('calibrate() before bias_correct()')
        x = self._images(images)
        fsites = float_sites(self._mcfg)
        with no_tf32(), torch.no_grad():
            fops = F32Ops(self._flat_f32(), self._mcfg['mean_pixel'])
            fops.capture = {}
            twin_forward(fops, x, self._mcfg)
        fmeans = {k: v.cpu().numpy() for k, v in fops.capture.items()}

        def qmeans():
            self._q_dev = None  # the biases with the current deltas
            # as the JAX package's capture pass: the default joins even
            # under s8_join
            ops = self._int8_ops(s8_join=False)
            ops.capture = {}
            with no_tf32(), torch.no_grad():
                twin_forward(ops, x, self._mcfg)
            return ops.capture

        for _ in range(max(1, passes)):
            means = qmeans()
            sites = [s for s in means if s not in fsites]
            for i, site in enumerate(sites):
                err = means[site].cpu().numpy() - fmeans[site]
                self.bias_delta[site] = np.asarray(
                    self.bias_delta.get(site, 0.0) - err, np.float32)
                if i + 1 < len(sites):  # re-measure downstream sites
                    means = qmeans()
        self._q_dev = None
        return {k: float(np.abs(v).max()) for k, v in self.bias_delta.items()}

    def _reset(self):
        self._flat_dev = None
        self._q_base = None
        self._q_dev = None
        self._alphas = {}

    def _images(self, images):
        """The batch on the device, its copy in the span
        ursonet.serve.h2d: a host batch bound for the card goes through
        the pinned staging ring (`utils/staging.py::to_device`)."""
        with span('ursonet.serve.h2d'):
            return to_device(images, self.device)

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
        bias + bias_delta)}; the float sites keep their f32 kernels. The
        weights are quantized once (`_q_base`), a 7x7 stem kernel's s2d
        form beside it (`_stem_w4`, the fused stem's 'nhwc' route: the
        same int8 values and scales); a change of bias_delta rebuilds the
        biases only."""
        if self._q_base is None:
            fsites = float_sites(self._mcfg)
            base = {}
            self._stem_w4 = {}
            for site, (w, b) in self.flat.items():
                if site in fsites:
                    continue
                w8, sw = quantize_weight(w)
                base[site] = (int8_cuda.kernel_layout(w8).to(self.device),
                              torch.from_numpy(sw).to(self.device),
                              np.asarray(b, np.float32))
                if site == self._stem_site and w8.shape[0] == 7:
                    self._stem_w4[site] = int8_cuda.kernel_layout(
                        stem_kernel_to_s2d(w8)).to(self.device)
            self._q_base = base
        if self._q_dev is None:
            q = {}
            for site, (w8, sw, b) in self._q_base.items():
                if site in self.bias_delta:
                    b = b + np.asarray(self.bias_delta[site], np.float32)
                q[site] = (w8, sw, torch.from_numpy(np.ascontiguousarray(b))
                           .to(self.device))
            self._q_dev = q
        return self._q_dev

    def _int8_ops(self, plain: bool = False, s8_join=None) -> Int8Ops:
        """The serving phase's ops; `s8_join` None takes the model's
        knob."""
        flat_dev = self._flat_f32()
        ffinal = {s: flat_dev[s] for s in float_sites(self._mcfg)
                  if s in flat_dev}
        return Int8Ops(self._prepared_q(), ffinal, self.act_scales,
                       mean_pixel=self._mcfg['mean_pixel'],
                       alphas=self._alphas, plain=plain,
                       fused_stem=self._mcfg['stem_s2d'],
                       acc_dtype=self.acc_dtype,
                       bf16_stem=self._mcfg['bf16_stem'],
                       s8_join=(self._mcfg['s8_join'] if s8_join is None
                                else s8_join),
                       stem_w4=self._stem_w4)

    def __call__(self, images, plain: bool = False):
        """int8 forward of a molded (float) or raw (uint8) [B,H,W,3]
        batch. plain=True runs the kernels' plain PyTorch versions
        (float64 accumulation) instead of the kernels, on any device: the
        reference the kernels are held against."""
        if self.act_scales is None:
            raise RuntimeError('calibrate() before inference')
        ops = self._int8_ops(plain)
        if self.mesh is not None:
            return self._sharded(ops, images)
        x = self._images(images)
        with span('ursonet.serve.forward'), no_tf32(), torch.no_grad():
            return twin_forward(ops, x, self._mcfg)

    def _sharded(self, ops, images):
        """This rank's rows through `ops`, the outputs gathered over
        'data' in row order (`shard_over`)."""
        from ursonet_torch.parallel.multihost import local_batch_slice
        from ursonet_torch.parallel.sharding import gather_rows
        n = int(images.shape[0])
        rows = self.mesh.shape['data']
        if n % rows:
            raise ValueError(
                f"batch {n} not divisible by the mesh's 'data' axis "
                f"({rows}); pad the batch (the engine's predict_molded "
                f"does) or serve unsharded")
        lo, hi = local_batch_slice(self.mesh, n)
        x = self._images(images[lo:hi])
        with span('ursonet.serve.forward'), no_tf32(), torch.no_grad():
            out = twin_forward(ops, x, self._mcfg)
        group = self.mesh.group('data')
        return {k: gather_rows(v, group, via_host=True)
                for k, v in out.items()}
