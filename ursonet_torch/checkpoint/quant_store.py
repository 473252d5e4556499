"""Load an int8 serving artifact (the port of
`ursonet_tpu/checkpoint/quant_store.py::load_quantized`).

The artifact is the msgpack file the JAX package's `save_quantized`
writes through flax: per conv/dense site the int8 kernel with its
per-channel f32 scale and f32 bias (f32 or f16 kernels for the sites
that serve in float), the calibrated activation scales, the model-config
snapshot `mcfg` and, optionally, `bias_delta`. The card's machine has
neither flax nor msgpack, so this module decodes the subset of msgpack
that flax writes by itself: maps, arrays, str/bin, ints, floats,
nil/bool, ext type 1 (ndarray: msgpack (shape, dtype name, C-order
bytes)), ext type 3 (numpy scalar, the same body) and flax's
`__msgpack_chunked_array__` dicts. `save_quantized` is not ported yet.
"""

from __future__ import annotations

import struct
from typing import Dict

import numpy as np

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

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


class _Reader:
    """msgpack decoder over one bytes object (big-endian wire format)."""

    def __init__(self, data: bytes, raw_str: bool = False):
        self.buf = memoryview(data)
        self.pos = 0
        self.raw_str = raw_str

    def _take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError('truncated msgpack data')
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def _unpack(self, fmt: str):
        size = struct.calcsize(fmt)
        return struct.unpack(fmt, self._take(size))[0]

    def _str(self, n: int):
        b = bytes(self._take(n))
        return b if self.raw_str else b.decode('utf-8')

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out

    def _ext(self, n: int):
        code = self._unpack('>b')
        body = bytes(self._take(n))
        if code in (_EXT_NDARRAY, _EXT_NPSCALAR):
            shape, dtype_name, data = _Reader(body, raw_str=True).read()
            name = dtype_name.decode() if isinstance(dtype_name, bytes) \
                else dtype_name
            if name == 'bfloat16':
                raise ValueError('bfloat16 arrays are not supported')
            arr = np.frombuffer(data, dtype=np.dtype(name)).reshape(
                tuple(shape)).copy()
            return arr if code == _EXT_NDARRAY else arr[()]
        raise ValueError(f'unsupported msgpack ext type {code}')

    def read(self):
        t = self._unpack('>B')
        if t <= 0x7f:
            return t
        if t >= 0xe0:
            return t - 0x100
        if 0x80 <= t <= 0x8f:
            return self._map(t & 0x0f)
        if 0x90 <= t <= 0x9f:
            return [self.read() for _ in range(t & 0x0f)]
        if 0xa0 <= t <= 0xbf:
            return self._str(t & 0x1f)
        simple = {0xc0: None, 0xc2: False, 0xc3: True}
        if t in simple:
            return simple[t]
        if t in (0xc4, 0xc5, 0xc6):          # bin 8/16/32
            n = self._unpack({0xc4: '>B', 0xc5: '>H', 0xc6: '>I'}[t])
            return bytes(self._take(n))
        if t in (0xc7, 0xc8, 0xc9):          # ext 8/16/32
            n = self._unpack({0xc7: '>B', 0xc8: '>H', 0xc9: '>I'}[t])
            return self._ext(n)
        if t == 0xca:
            return self._unpack('>f')
        if t == 0xcb:
            return self._unpack('>d')
        ints = {0xcc: '>B', 0xcd: '>H', 0xce: '>I', 0xcf: '>Q',
                0xd0: '>b', 0xd1: '>h', 0xd2: '>i', 0xd3: '>q'}
        if t in ints:
            return self._unpack(ints[t])
        if 0xd4 <= t <= 0xd8:                # fixext 1/2/4/8/16
            return self._ext(1 << (t - 0xd4))
        if t in (0xd9, 0xda, 0xdb):          # str 8/16/32
            return self._str(self._unpack({0xd9: '>B', 0xda: '>H',
                                           0xdb: '>I'}[t]))
        if t in (0xdc, 0xdd):                # array 16/32
            n = self._unpack('>H' if t == 0xdc else '>I')
            return [self.read() for _ in range(n)]
        if t in (0xde, 0xdf):                # map 16/32
            return self._map(self._unpack('>H' if t == 0xde else '>I'))
        raise ValueError(f'unsupported msgpack type byte 0x{t:02x}')


def _unchunk(tree):
    """flax's chunked-array dicts back into arrays."""
    if isinstance(tree, dict):
        if '__msgpack_chunked_array__' in tree:
            shape = tuple(tree['shape'][str(i)]
                          for i in range(len(tree['shape'])))
            chunks = [tree['chunks'][str(i)]
                      for i in range(len(tree['chunks']))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def msgpack_restore(data: bytes):
    """Decode flax-written msgpack bytes into nested dicts, lists,
    Python scalars and numpy arrays (as flax.serialization.msgpack_restore
    does)."""
    reader = _Reader(data)
    tree = reader.read()
    if reader.pos != len(reader.buf):
        raise ValueError('trailing bytes after the msgpack object')
    return _unchunk(tree)


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
            continue  # informational entries (e.g. stem_s2d)
        want = getattr(config, ckey, missing)
        if want is missing:
            raise ValueError(f'artifact/config mismatch: config has no '
                             f'{ckey} (artifact {key}={val!r})')
        if _norm(want) != _norm(val):
            raise ValueError(
                f'artifact/config mismatch on {key}: {val!r} != {want!r}')


def load_quantized(path: str, config, device='cuda'):
    """Load a serving artifact; returns a calibrated QuantizedModel on
    `device`."""
    from ursonet_torch.models.quant import QuantizedModel
    with open(path, 'rb') as f:
        tree = msgpack_restore(f.read())
    if tree.get('format') != 'ursonet-int8-ptq-v1':
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
