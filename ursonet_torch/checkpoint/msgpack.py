"""msgpack in the subset that flax's `serialization.msgpack_serialize`
writes and `msgpack_restore` reads, on the standard library alone: the
card's machine has neither flax nor msgpack.

Types: maps, arrays (lists and tuples), str, bin, ints, floats (double),
nil, bool, ext type 1 (ndarray: a msgpack (shape, dtype name, C-order
bytes)), ext type 3 (numpy scalar, the same body) and flax's
`__msgpack_chunked_array__` dicts for arrays above MAX_CHUNK_SIZE bytes.
`msgpack_serialize` writes what flax writes for the same tree, so each
package reads the other's files: weight snapshots, train states and int8
serving artifacts.
"""

from __future__ import annotations

import struct

import numpy as np

# flax.serialization.MAX_CHUNK_SIZE: arrays above it are split
MAX_CHUNK_SIZE = 2 ** 30
_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3



# --------------------------------------------------------------------------
# decoder


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



# --------------------------------------------------------------------------
# encoder


# The encoder appends byte strings to a list `out`, joined once at the
# end: an array's bytes are copied once more, not once per nesting level.


def _ext_header(code: int, n: int) -> bytes:
    fixed = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
    if n in fixed:
        return struct.pack('>Bb', fixed[n], code)
    if n < 1 << 8:
        return struct.pack('>BBb', 0xc7, n, code)
    if n < 1 << 16:
        return struct.pack('>BHb', 0xc8, n, code)
    return struct.pack('>BIb', 0xc9, n, code)


def _pack_ndarray(code: int, a: np.ndarray, out: list) -> None:
    """ext `code` whose body is the msgpack of [shape, dtype name,
    C-order bytes]."""
    if a.dtype.name == 'bfloat16' or a.dtype.kind not in 'biuf':
        raise ValueError(f'unsupported array dtype {a.dtype}')
    data = np.ascontiguousarray(a).tobytes()
    body = [b'\x93']                 # an array of three
    _pack(list(a.shape), body)
    _pack(a.dtype.name, body)
    body += [_bin_header(len(data)), data]
    out.append(_ext_header(code, sum(len(p) for p in body)))
    out.extend(body)


def _bin_header(n: int) -> bytes:
    if n < 1 << 8:
        return struct.pack('>BB', 0xc4, n)
    if n < 1 << 16:
        return struct.pack('>BH', 0xc5, n)
    return struct.pack('>BI', 0xc6, n)


def _int(v: int) -> bytes:
    if 0 <= v <= 0x7f or -32 <= v < 0:
        return struct.pack('>b' if v < 0 else '>B', v)
    if v >= 0:
        for code, fmt, top in ((0xcc, '>B', 1 << 8), (0xcd, '>H', 1 << 16),
                               (0xce, '>I', 1 << 32), (0xcf, '>Q', 1 << 64)):
            if v < top:
                return struct.pack('>B', code) + struct.pack(fmt, v)
    else:
        for code, fmt, lo in ((0xd0, '>b', -(1 << 7)),
                              (0xd1, '>h', -(1 << 15)),
                              (0xd2, '>i', -(1 << 31)),
                              (0xd3, '>q', -(1 << 63))):
            if v >= lo:
                return struct.pack('>B', code) + struct.pack(fmt, v)
    raise OverflowError(f'int {v} does not fit msgpack')


def _len_header(n: int, fix: int, fix_max: int, codes) -> bytes:
    """A length header: the fix form below fix_max, else 8/16/32 bits
    (codes holds the 16- and 32-bit codes, with the 8-bit one first
    where the type has it)."""
    if n < fix_max:
        return struct.pack('>B', fix | n)
    if len(codes) == 3 and n < 1 << 8:
        return struct.pack('>BB', codes[0], n)
    if n < 1 << 16:
        return struct.pack('>BH', codes[-2], n)
    return struct.pack('>BI', codes[-1], n)


def _pack(x, out: list) -> None:
    if x is None:
        out.append(b'\xc0')
    elif isinstance(x, np.generic):
        _pack_ndarray(_EXT_NPSCALAR, np.asarray(x), out)
    elif isinstance(x, np.ndarray):
        _pack_ndarray(_EXT_NDARRAY, x, out)
    elif isinstance(x, bool):
        out.append(b'\xc3' if x else b'\xc2')
    elif isinstance(x, int):
        out.append(_int(x))
    elif isinstance(x, float):
        out.append(struct.pack('>Bd', 0xcb, x))
    elif isinstance(x, str):
        b = x.encode('utf-8')
        out += [_len_header(len(b), 0xa0, 32, (0xd9, 0xda, 0xdb)), b]
    elif isinstance(x, (bytes, bytearray)):
        out += [_bin_header(len(x)), bytes(x)]
    elif isinstance(x, (list, tuple)):
        out.append(_len_header(len(x), 0x90, 16, (0xdc, 0xdd)))
        for v in x:
            _pack(v, out)
    elif isinstance(x, dict):
        out.append(_len_header(len(x), 0x80, 16, (0xde, 0xdf)))
        for k, v in x.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f'cannot serialize {type(x).__name__}')


def _chunked(tree):
    """The tree as flax packs it: each dict's keys sorted (flax maps the
    tree through jax.tree_util first, which sorts them), arrays above
    MAX_CHUNK_SIZE bytes as flax's chunked-array dicts."""
    if isinstance(tree, dict):
        return {k: _chunked(tree[k]) for k in sorted(tree)}
    if isinstance(tree, np.ndarray) and tree.nbytes > MAX_CHUNK_SIZE:
        size = max(1, MAX_CHUNK_SIZE // tree.dtype.itemsize)
        flat = tree.reshape(-1)
        chunks = [flat[i:i + size] for i in range(0, flat.size, size)]
        return {'__msgpack_chunked_array__': True,
                'shape': {str(i): d for i, d in enumerate(tree.shape)},
                'chunks': {str(i): c for i, c in enumerate(chunks)}}
    return tree


def msgpack_serialize(tree) -> bytes:
    """Nested dicts / lists of Python scalars, str, bytes, numpy arrays
    and numpy scalars -> msgpack bytes, as
    flax.serialization.msgpack_serialize writes them."""
    out = []
    _pack(_chunked(tree), out)
    return b''.join(out)
