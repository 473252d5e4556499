"""The int8 serving artifact, the port of
`ursonet_tpu/checkpoint/quant_store.py` (`save_quantized`,
`load_quantized`), in the JAX package's msgpack layout
(`checkpoint/msgpack.py`): each package reads the other's artifacts.

An artifact holds, per conv/dense site, the int8 kernel with its
per-channel f32 scale and f32 bias (f32 or f16 kernels for the sites
that serve in float), the calibrated activation scales, the model-config
snapshot `mcfg` and, optionally, `bias_delta`.

An artifact saved after the space-to-depth rewrite stores its stem
kernel in (4,4,12,64) form and loads as such: `stem_s2d` and `host_s2d`
in its `mcfg` are informational (the model derives the first from the
kernel's shape and the second from the config's QUANT_HOST_S2D), so
neither is checked against a config knob.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from ursonet_torch.checkpoint.msgpack import msgpack_restore, \
    msgpack_serialize
from ursonet_torch.checkpoint.store import _atomic_write

FORMAT = 'ursonet-int8-ptq-v1'

_CONFIG_KEYS: Dict[str, str] = {
    'backbone': 'BACKBONE',
    'nr_dense_layers': 'NR_DENSE_LAYERS',
    'regress_loc': 'REGRESS_LOC',
    'regress_ori': 'REGRESS_ORI',
    'regress_keypoints': 'REGRESS_KEYPOINTS',
    'orientation_param': 'ORIENTATION_PARAM',
    'loc_bins': 'LOC_BINS_PER_DIM',
    'ori_bins': 'ORI_BINS_PER_DIM',
    'mean_pixel': 'MEAN_PIXEL',
    'bf16_stem': 'QUANT_BF16_STEM',
    'float_cls_final': 'QUANT_FLOAT_CLS_FINAL',
    'float_reg_head': 'QUANT_FLOAT_REG_HEAD',
}


def _norm(v):
    if isinstance(v, (list, tuple, np.ndarray)):
        return tuple(float(x) for x in v)
    return v


def check_mcfg(mcfg: dict, config) -> None:
    """Raise unless the artifact's model-config snapshot matches
    `config` on every key the config can express."""
    missing = object()
    for key, val in mcfg.items():
        ckey = _CONFIG_KEYS.get(key)
        if ckey is None:
            continue  # informational entries (stem_s2d, host_s2d, s8_join)
        want = getattr(config, ckey, missing)
        if want is missing:
            raise ValueError(f'artifact/config mismatch: config has no '
                             f'{ckey} (artifact {key}={val!r})')
        if _norm(want) != _norm(val):
            raise ValueError(
                f'artifact/config mismatch on {key}: {val!r} != {want!r}')


def save_quantized(path: str, qmodel, float_dtype=np.float32) -> None:
    """Write a calibrated QuantizedModel to `path` (atomically): each
    quantized site's kernel as `quantize_weight` gives it (int8 kernel
    and per-channel scale; re-quantizing their product gives the kernel
    back), the float sites' kernels in `float_dtype` (np.float16 halves
    the large head finals; the loader widens them to f32)."""
    from ursonet_torch.models.quant import float_sites, quantize_weight
    if qmodel.act_scales is None:
        raise ValueError('calibrate() the model before saving')
    fsites = float_sites(qmodel._mcfg)
    flat_out = {}
    for site, (w, b) in qmodel.flat.items():
        w = np.asarray(w, np.float32)
        b = np.asarray(b, np.float32)
        if site in fsites:
            flat_out[site] = {'kernel': w.astype(float_dtype), 'bias': b}
        else:
            w8, sw = quantize_weight(w)
            flat_out[site] = {'kernel_q': w8, 'scale': sw, 'bias': b}
    tree = {
        'format': FORMAT,
        'mcfg': {k: list(v) if isinstance(v, tuple) else v
                 for k, v in qmodel._mcfg.items()},
        'act_scales': {k: np.float32(v) for k, v in qmodel.act_scales.items()},
        'flat': flat_out,
    }
    if qmodel.bias_delta:
        # int8-path-only bias terms, outside 'flat': the float twin stays
        # the uncorrected reference
        tree['bias_delta'] = {k: np.asarray(v, np.float32)
                              for k, v in qmodel.bias_delta.items()}
    _atomic_write(path, msgpack_serialize(tree))


def load_quantized(path: str, config, device='cuda'):
    """Load a serving artifact; returns a calibrated QuantizedModel on
    `device`. The epilogues' accumulation mode comes from config.F16 (bf16
    under F16), as in the JAX package: the artifact does not record it."""
    from ursonet_torch.models.quant import QuantizedModel
    with open(path, 'rb') as f:
        tree = msgpack_restore(f.read())
    if tree.get('format') != FORMAT:
        raise ValueError(f'not an int8-PTQ artifact: {path}')
    check_mcfg(tree['mcfg'], config)
    flat = {}
    for site, node in tree['flat'].items():
        b = np.asarray(node['bias'], np.float32)
        if 'kernel_q' in node:
            # dequantize; quantize_weight gives kernel_q back exactly
            w = (np.asarray(node['kernel_q'], np.float32)
                 * np.asarray(node['scale'], np.float32))
        else:
            w = np.asarray(node['kernel'], np.float32)
        flat[site] = (w, b)
    qm = QuantizedModel(config, flat, device)
    qm.act_scales = {k: float(v) for k, v in tree['act_scales'].items()}
    if 'bias_delta' in tree:
        qm.bias_delta = {k: np.asarray(v, np.float32)
                         for k, v in tree['bias_delta'].items()}
    return qm
