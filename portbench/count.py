"""Operations and bytes of the UrsoNet ResNet-50/101 models, per layer,
from a configuration's shapes alone.

`layers(model, h, w)` lists every conv and dense of the model at an input
of h x w pixels, in graph order, with its shapes and its multiply-adds
per image. `serve_bound(model, h, w, batch)` gives, per family of the
int8 kernels, the least time the card needs for one served batch:
Σ max(ops / peak int8 rate, bytes / peak bandwidth) over the calls, each
call's bytes counted once (its int8 input, its int8 weights, its output
in the type its epilogue writes, the residual a join reads, the per-channel
scale and bias). `train_flops(model, h, w)` gives a train step's float
operations per image: forward, and the input and weight gradients of
every conv and dense (the stem has no input gradient).

Peaks are NVIDIA's data sheet for one H100 SXM at 700 W, dense, without
sparsity.
"""

from __future__ import annotations

from typing import Dict, List

PEAK_INT8_OPS = 1979e12      # int8 tensor-core operations a second
PEAK_BF16_FLOPS = 989e12     # bf16 tensor-core FLOP/s
PEAK_HBM_BYTES = 3.35e12     # HBM3 bytes a second
STAGE4_BLOCKS = {'resnet50': 5, 'resnet101': 22}
STAGES = ((2, (64, 64, 256), 1), (3, (128, 128, 512), 2),
          (4, (256, 256, 1024), 2), (5, (512, 512, 2048), 2))


def _ceil2(n: int) -> int:
    return -(-n // 2)


def layers(model: dict, h: int, w: int) -> List[dict]:
    """Every conv and dense: name, kind ('stem', 'conv3', 'conv1',
    'dense'), input h, w, c, output h, w, c, kernel size, stride, whether
    its epilogue joins a residual, and macs per image."""
    out = []

    def conv(name, kind, hi, wi, ci, co, k, s, join=False):
        ho, wo = (_ceil2(hi), _ceil2(wi)) if s == 2 else (hi, wi)
        out.append(dict(name=name, kind=kind, h=hi, w=wi, c=ci, ho=ho, wo=wo,
                        co=co, k=k, stride=s, join=join,
                        macs=ho * wo * co * k * k * ci))
        return ho, wo

    hh, ww = conv('conv1', 'stem', h, w, 3, 64, 7, 2)
    hh, ww = _ceil2(hh), _ceil2(ww)                      # 3x3/2 maxpool
    c = 64
    for stage, (f1, f2, f3), stride in STAGES:
        n = 3 if stage in (2, 5) else 4 if stage == 3 \
            else 1 + STAGE4_BLOCKS[model['backbone']]
        for i in range(n):
            blk = f'res{stage}{chr(97 + i)}_branch'
            s = stride if i == 0 else 1
            if i == 0:
                conv(blk + '1', 'conv1', hh, ww, c, f3, 1, s)
            h2, w2 = conv(blk + '2a', 'conv1', hh, ww, c, f1, 1, s)
            conv(blk + '2b', 'conv3', h2, w2, f1, f2, 3, 1)
            conv(blk + '2c', 'conv1', h2, w2, f2, f3, 1, 1, join=True)
            hh, ww, c = h2, w2, f3
    hh, ww = conv('bottleneck_layer', 'conv3', hh, ww, c,
                  model['bottleneck_width'], 3, 2)
    feats = hh * ww * model['bottleneck_width']
    heads = ['loc'] if model['regress_keypoints'] else ['loc', 'ori']
    for p in heads:
        n_in = feats
        for i in range(model['nr_dense_layers']):
            out.append(dict(name=f'{p}_head/{p}_dense_{i}', kind='dense',
                            k_in=n_in, n_out=model['branch_size'],
                            macs=n_in * model['branch_size']))
            n_in = model['branch_size']
        finals = [('k1_final', 3), ('k2_final', 3), ('k3_final', 3)] \
            if model['regress_keypoints'] else \
            [('loc_final', 3)] if p == 'loc' else \
            [('ori_final', model['ori_bins'] ** 3)]
        for name, n_out in finals:
            out.append(dict(name=f'{p}_head/{name}', kind='dense',
                            k_in=n_in, n_out=n_out, macs=n_in * n_out))
    return out


def float_finals(model: dict) -> set:
    """The final denses served in float (bf16 matmuls, not int8 kernels)."""
    if model['regress_keypoints']:
        return {'loc_head/k1_final', 'loc_head/k2_final', 'loc_head/k3_final'}
    return {'loc_head/loc_final'}


def _out_bytes(layer: dict, model: dict, bf16: bool) -> int:
    """Bytes an output element of the int8 kernel's epilogue takes: the
    requantized int8 activation, or a float one (bf16 under F16, else
    f32) where the consumer is float: the bottleneck conv before the
    flatten, a last hidden dense before a float final, the classifier."""
    out_f = 2 if bf16 else 4
    name = layer['name']
    if name == 'bottleneck_layer':
        return out_f
    if layer['kind'] == 'dense':
        if name.endswith('_final'):
            return out_f
        last = name.endswith(f"_dense_{model['nr_dense_layers'] - 1}")
        if last and (model['regress_keypoints'] or name.startswith('loc')):
            return out_f
    return 1


def serve_bound(model: dict, h: int, w: int, batch: int,
                bf16: bool = True) -> Dict[str, dict]:
    """{family: {'ops', 'bytes', 'bound_s', 'by_ops'}} of one served batch
    for the int8 kernels: 'int8_gemm' (1x1 convs and int8 denses),
    'int8_conv' (3x3 convs), 'int8_stem' (the 7x7/2 stem with its input
    quantize and maxpool). 'by_ops' says whether operations bound the
    family's largest share of calls' bounds."""
    fams: Dict[str, dict] = {}
    ffin = float_finals(model)
    for l in layers(model, h, w):
        if l['name'] in ffin:
            continue
        ops = 2.0 * l['macs'] * batch
        if l['kind'] == 'dense':
            m, k, n = batch, l['k_in'], l['n_out']
            byts = m * k + k * n + m * n * _out_bytes(l, model, bf16) + 8 * n
            fam = 'int8_gemm'
        elif l['kind'] == 'stem':
            pooled = _ceil2(l['ho']) * _ceil2(l['wo']) * l['co']
            byts = batch * (l['h'] * l['w'] * l['c'] + pooled) \
                + l['k'] ** 2 * l['c'] * l['co'] + 8 * l['co']
            fam = 'int8_stem'
        else:
            m = batch * l['ho'] * l['wo']
            n = l['co']
            x_in = m * l['c'] if l['kind'] == 'conv1' \
                else batch * l['h'] * l['w'] * l['c']
            byts = x_in + l['k'] ** 2 * l['c'] * n \
                + m * n * _out_bytes(l, model, bf16) + 8 * n
            if l['join']:
                byts += m * n
            fam = 'int8_gemm' if l['kind'] == 'conv1' else 'int8_conv'
        t_ops, t_bytes = ops / PEAK_INT8_OPS, byts / PEAK_HBM_BYTES
        f = fams.setdefault(fam, dict(ops=0.0, bytes=0.0, bound_s=0.0,
                                      ops_s=0.0, bytes_s=0.0))
        f['ops'] += ops
        f['bytes'] += byts
        f['bound_s'] += max(t_ops, t_bytes)
        f['ops_s' if t_ops >= t_bytes else 'bytes_s'] += max(t_ops, t_bytes)
    for f in fams.values():
        f['by_ops'] = f.pop('ops_s') >= f.pop('bytes_s')
    return fams


def train_flops(model: dict, h: int, w: int) -> Dict[str, float]:
    """Float operations of a train step, an image: 'forward' (2 x macs of
    every conv and dense), and 'matmul', the forward with the weight
    gradient of every layer and the input gradient of every layer but the
    stem, whose input needs none."""
    fwd = sum(2.0 * l['macs'] for l in layers(model, h, w))
    stem = 2.0 * layers(model, h, w)[0]['macs']
    return {'forward': fwd, 'matmul': 3.0 * fwd - stem}
