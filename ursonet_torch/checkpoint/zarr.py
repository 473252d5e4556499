"""zarr v2 arrays in a key-value store, as tensorstore's zarr driver lays
them out under Orbax: `<name>/.zarray` (JSON) and one value per chunk,
`<name>/<i>.<j>...` (`<name>/0` for a 0-d array), each chunk its C-order
bytes in a zstd frame.

    read_array(get, name) -> np.ndarray    get(key) -> bytes or None
    array_items(name, a) -> {key: bytes}   one chunk, the JSON Orbax writes

Reading takes any chunk grid in C order with `dimension_separator` '.',
a zstd compressor or none, and a `fill_value` of null: a chunk that is
missing reads as zeros. Anything else raises ValueError naming it.
"""

from __future__ import annotations

import itertools
import json
import math
from typing import Callable, Dict, Optional

import numpy as np

from ursonet_torch.checkpoint import zstd

ZARRAY = '.zarray'


def read_array(get: Callable[[str], Optional[bytes]], name: str
               ) -> np.ndarray:
    """The array `name` of the store `get` reads from."""
    raw = get(f'{name}/{ZARRAY}')
    if raw is None:
        raise KeyError(f'zarr: no array {name!r} ({name}/{ZARRAY} missing)')
    meta = json.loads(raw)
    if meta.get('zarr_format') != 2:
        raise ValueError(f'zarr {name}: zarr_format {meta.get("zarr_format")}')
    if meta.get('filters'):
        raise ValueError(f'zarr {name}: filters {meta["filters"]} are not '
                         'supported')
    comp = meta.get('compressor')
    if comp is not None and comp.get('id') != 'zstd':
        raise ValueError(f'zarr {name}: compressor {comp.get("id")!r} is not '
                         'supported')
    for key, want in (('order', 'C'), ('dimension_separator', '.'),
                      ('fill_value', None)):
        if meta.get(key, want) != want:
            raise ValueError(f'zarr {name}: {key} {meta[key]!r} is not '
                             'supported')
    dtype = np.dtype(meta['dtype'])
    shape = tuple(meta['shape'])
    chunks = tuple(meta['chunks'])
    if len(chunks) != len(shape):
        raise ValueError(f'zarr {name}: chunks {chunks} for shape {shape}')
    out = np.zeros(shape, dtype)
    grid = [range(math.ceil(s / c)) if c else range(0)
            for s, c in zip(shape, chunks)]
    want = int(np.prod(chunks)) * dtype.itemsize
    for idx in itertools.product(*grid):
        key = f'{name}/' + ('.'.join(map(str, idx)) if idx else '0')
        data = get(key)
        if data is None:
            continue                      # a missing chunk: zeros
        if comp is not None:
            data = zstd.decompress(data, want)
        if len(data) != want:
            raise ValueError(f'zarr {key}: {len(data)} bytes, a chunk of '
                             f'{chunks} {dtype} has {want}')
        chunk = np.frombuffer(data, dtype).reshape(chunks)
        region = tuple(slice(i * c, min((i + 1) * c, s))
                       for i, c, s in zip(idx, chunks, shape))
        out[region] = chunk[tuple(slice(0, r.stop - r.start)
                                  for r in region)]
    return out


def array_items(name: str, a: np.ndarray) -> Dict[str, bytes]:
    """The keys and values of `a` stored as `name`: one chunk, C order,
    zstd frames of raw blocks (`zstd.frame_raw`), fill_value null."""
    a = np.asarray(a)
    if a.dtype.byteorder == '>':
        a = a.astype(a.dtype.newbyteorder('<'))
    meta = {'chunks': list(a.shape),
            'compressor': {'id': 'zstd', 'level': 1},
            'dimension_separator': '.', 'dtype': a.dtype.str,
            'fill_value': None, 'filters': None, 'order': 'C',
            'shape': list(a.shape), 'zarr_format': 2}
    chunk = '.'.join('0' for _ in a.shape) or '0'
    return {f'{name}/{ZARRAY}': json.dumps(meta, sort_keys=True,
                                           separators=(',', ':')).encode(),
            f'{name}/{chunk}': zstd.frame_raw(np.ascontiguousarray(a)
                                              .tobytes())}
