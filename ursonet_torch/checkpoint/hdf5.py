"""HDF5 reader and writer on the standard library and numpy, for the
subset that Keras weight files use: the port's replacement for h5py,
through which `checkpoint/h5_import.py` reads and writes Keras weights.

    with File(path) as f:                      # read
        names = f.attrs['layer_names']         # ndarray of bytes
        kernel = np.asarray(f['conv1']['conv1/kernel:0'])
    with File(path, 'w') as f:                 # write, on close
        g = f.create_group('conv1')
        g.create_dataset('conv1/kernel:0', data=kernel)
        g.attrs['weight_names'] = [b'conv1/kernel:0']

The reader takes what h5py writes by default (libver "earliest") and
what Keras 2 wrote for its released weights:
  * superblock version 0 or 1, at offset 0;
  * version-1 object headers, their continuation blocks included;
  * groups as symbol tables (a v1 B-tree of group nodes over symbol-table
    nodes, names in a local heap), nested to any depth;
  * datasets in contiguous or compact layout of IEEE floats (f2, f4,
    f8), integers and fixed-length strings, either byte order;
  * attributes of those types, scalar or array, and variable-length
    strings from the global heap (how h5py stores a Python str).
Anything else (chunked, filtered or external data, superblock 2/3, a
user block, version-2 object headers, groups of link messages, dense
attribute storage, shared messages, soft links, compound and other
datatypes) raises ValueError naming the file, the object and the
feature.

The writer lays out groups (symbol tables: leaf K 4, internal K 16, as
HDF5's defaults), contiguous numeric datasets (little-endian) and
numeric or fixed-length-string attributes in the same version-0 format,
so h5py reads its files. Values go out when the file closes.
"""

from __future__ import annotations

import struct
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

SIGNATURE = b'\x89HDF\r\n\x1a\n'
UNDEF = 0xFFFFFFFFFFFFFFFF

# object header message types
_NIL, _DATASPACE, _LINK_INFO, _DATATYPE = 0x00, 0x01, 0x02, 0x03
_FILL, _LINK, _EXTERNAL, _LAYOUT = 0x05, 0x06, 0x07, 0x08
_FILTERS, _ATTRIBUTE, _CONTINUATION, _SYMBOL_TABLE = 0x0B, 0x0C, 0x10, 0x11
_ATTRIBUTE_INFO = 0x15

# IEEE float layouts: size -> (exponent location, exponent size,
# mantissa size, exponent bias)
_IEEE = {2: (10, 5, 10, 15), 4: (23, 8, 23, 127), 8: (52, 11, 52, 1023)}


def _pad8(n: int) -> int:
    return (n + 7) & ~7


# --------------------------------------------------------------------------
# reader


class _Image:
    """The bytes of one file and its superblock's sizes."""

    def __init__(self, path: str, data: bytes):
        self.path = path
        self.data = memoryview(data)
        if bytes(self.data[:8]) != SIGNATURE:
            raise ValueError(f'{path}: not an HDF5 file (no signature at '
                             'offset 0)')
        version = self.u8(8)
        if version not in (0, 1):
            self.fail('/', f'superblock version {version} (written with '
                      'libver "latest"; versions 0 and 1 are read)')
        self.O = self.u8(13)
        self.L = self.u8(14)
        if self.O not in (2, 4, 8) or self.L not in (2, 4, 8):
            self.fail('/', f'offset size {self.O} / length size {self.L}')
        pos = 24 + (4 if version == 1 else 0)
        if self._int(pos, self.O) != 0:
            self.fail('/', 'a base address other than 0 (a user block)')
        pos += 4 * self.O       # base, free-space, end-of-file, VFD info
        # the root group's symbol table entry
        self.root_header = self.addr(pos + self.O)
        self.heaps: Dict[int, List[Tuple[int, bytes]]] = {}

    def fail(self, obj: str, feature: str):
        raise ValueError(f'{self.path}: {obj}: unsupported HDF5 feature: '
                         f'{feature}')

    def _int(self, pos: int, n: int) -> int:
        if pos < 0 or pos + n > len(self.data):
            raise ValueError(f'{self.path}: truncated file (read of {n} '
                             f'bytes at {pos})')
        return int.from_bytes(self.data[pos:pos + n], 'little')

    def u8(self, pos):
        return self._int(pos, 1)

    def u16(self, pos):
        return self._int(pos, 2)

    def u32(self, pos):
        return self._int(pos, 4)

    def length(self, pos):
        return self._int(pos, self.L)

    def addr(self, pos):
        """A file address at `pos` (UNDEF for the undefined address)."""
        a = self._int(pos, self.O)
        return UNDEF if a == (1 << 8 * self.O) - 1 else a

    def raw(self, pos: int, n: int) -> bytes:
        if pos < 0 or pos + n > len(self.data):
            raise ValueError(f'{self.path}: truncated file (read of {n} '
                             f'bytes at {pos})')
        return bytes(self.data[pos:pos + n])

    def cstr(self, pos: int) -> bytes:
        end = pos
        while self.data[end] != 0:
            end += 1
        return bytes(self.data[pos:end])

    def sig(self, pos: int, want: bytes, obj: str):
        if self.raw(pos, 4) != want:
            raise ValueError(f'{self.path}: {obj}: expected {want!r} at '
                             f'{pos}, found {self.raw(pos, 4)!r}')

    # -- object headers ------------------------------------------------------

    def messages(self, addr: int, obj: str) -> List[Tuple[int, int, int]]:
        """(type, flags, body offset) of every message of the version-1
        object header at `addr`, continuation blocks followed."""
        if self.raw(addr, 4) == b'OHDR':
            self.fail(obj, 'version-2 object header (libver "latest")')
        if self.u8(addr) != 1:
            self.fail(obj, f'object header version {self.u8(addr)}')
        count = self.u16(addr + 2)
        blocks = [(addr + 16, self.u32(addr + 8))]
        out = []
        seen = 0
        while blocks and seen < count:
            pos, size = blocks.pop(0)
            end = pos + size
            while pos + 8 <= end and seen < count:
                mtype, msize = self.u16(pos), self.u16(pos + 2)
                flags = self.u8(pos + 4)
                body = pos + 8
                seen += 1
                if flags & 0x02:
                    self.fail(obj, f'shared object header message (type '
                              f'{mtype:#x})')
                if mtype == _CONTINUATION:
                    blocks.append((self.addr(body),
                                   self.length(body + self.O)))
                elif mtype != _NIL:
                    out.append((mtype, flags, body))
                pos = body + msize
        return out

    # -- datatypes, dataspaces -------------------------------------------------

    def datatype(self, pos: int, obj: str):
        """('num', numpy dtype) | ('str', size) | ('vlen_str', None)."""
        cv = self.u8(pos)
        cls = cv & 0x0F
        bits = self.u8(pos + 1) | self.u8(pos + 2) << 8 \
            | self.u8(pos + 3) << 16
        size = self.u32(pos + 4)
        order = '>' if bits & 0x01 else '<'
        if cls == 0:                                  # fixed point
            offset, precision = self.u16(pos + 8), self.u16(pos + 10)
            if offset != 0 or precision != 8 * size or size not in (1, 2, 4,
                                                                    8):
                self.fail(obj, f'integer of {precision} bits at offset '
                          f'{offset} in {size} bytes')
            kind = 'i' if bits & 0x08 else 'u'
            return 'num', np.dtype(f'{order}{kind}{size}')
        if cls == 1:                                  # floating point
            if bits & 0x40:
                self.fail(obj, 'VAX-endian float')
            props = (self.u16(pos + 8), self.u16(pos + 10), self.u8(pos + 12),
                     self.u8(pos + 13), self.u8(pos + 14), self.u8(pos + 15),
                     self.u32(pos + 16))
            ieee = _IEEE.get(size)
            if ieee is None or props != (0, 8 * size, ieee[0], ieee[1], 0,
                                         ieee[2], ieee[3]):
                self.fail(obj, f'non-IEEE float of {size} bytes {props}')
            return 'num', np.dtype(f'{order}f{size}')
        if cls == 3:                                  # fixed-length string
            return 'str', size
        if cls == 9:                                  # variable length
            if bits & 0x0F != 1:
                self.fail(obj, 'variable-length sequence')
            return 'vlen_str', None
        names = {2: 'time', 4: 'bitfield', 5: 'opaque', 6: 'compound',
                 7: 'reference', 8: 'enum', 10: 'array'}
        self.fail(obj, f'{names.get(cls, f"class {cls}")} datatype')

    def dataspace(self, pos: int, obj: str) -> Optional[Tuple[int, ...]]:
        """The shape (() for a scalar), None for a null dataspace."""
        version, rank = self.u8(pos), self.u8(pos + 1)
        if version == 1:
            start = pos + 8
        elif version == 2:
            if self.u8(pos + 3) == 2:
                return None
            start = pos + 4
        else:
            self.fail(obj, f'dataspace version {version}')
        return tuple(self.length(start + i * self.L) for i in range(rank))

    # -- values ------------------------------------------------------------------

    def gheap(self, addr: int, index: int, obj: str) -> bytes:
        """Object `index` of the global heap collection at `addr`."""
        objs = self.heaps.get(addr)
        if objs is None:
            self.sig(addr, b'GCOL', obj)
            end = addr + self.length(addr + 8)
            pos = addr + 8 + self.L
            objs = []
            while pos + 8 + self.L <= end:
                idx = self.u16(pos)
                if idx == 0:            # the free space: the end
                    break
                size = self.length(pos + 8)
                objs.append((idx, self.raw(pos + 8 + self.L, size)))
                pos += 8 + self.L + _pad8(size)
            self.heaps[addr] = objs
        for idx, data in objs:
            if idx == index:
                return data
        raise ValueError(f'{self.path}: {obj}: global heap object {index} '
                         f'missing in the collection at {addr}')

    def values(self, dtype, shape, pos: int, obj: str):
        """The array (numpy scalar, str or bytes for a scalar shape) of
        `shape` stored at `pos` as `dtype`."""
        kind, info = dtype
        n = int(np.prod(shape)) if shape else 1
        if kind == 'num':
            a = np.frombuffer(self.raw(pos, n * info.itemsize), info)
            a = a.astype(info.newbyteorder('=')).reshape(shape)
            return a[()] if shape == () else a
        if kind == 'str':
            a = np.frombuffer(self.raw(pos, n * info), f'S{info}')
            a = a.reshape(shape).copy()
            return a[()] if shape == () else a
        step = 4 + self.O + 4           # length, collection, index
        items = []
        for i in range(n):
            p = pos + i * step
            heap = self.addr(p + 4)
            data = b'' if heap == UNDEF or self.u32(p) == 0 else \
                self.gheap(heap, self.u32(p + 4 + self.O), obj)
            items.append(data[:self.u32(p)].decode('utf-8'))
        if shape == ():
            return items[0]
        a = np.empty(n, object)
        a[:] = items
        return a.reshape(shape)

    def attribute(self, pos: int, obj: str) -> Tuple[str, object]:
        version, flags = self.u8(pos), self.u8(pos + 1)
        nsize, tsize, ssize = (self.u16(pos + 2), self.u16(pos + 4),
                               self.u16(pos + 6))
        if version == 1:
            pad, p = _pad8, pos + 8
        elif version in (2, 3):
            if flags & 0x03:
                self.fail(obj, 'shared attribute datatype or dataspace')
            pad, p = (lambda n: n), pos + 8 + (1 if version == 3 else 0)
        else:
            self.fail(obj, f'attribute message version {version}')
        name = self.raw(p, nsize).rstrip(b'\0').decode('utf-8')
        p += pad(nsize)
        dtype = self.datatype(p, f'{obj} attribute {name!r}')
        p += pad(tsize)
        shape = self.dataspace(p, f'{obj} attribute {name!r}')
        p += pad(ssize)
        if shape is None:
            return name, None
        return name, self.values(dtype, shape, p, f'{obj} attribute {name!r}')

    # -- groups --------------------------------------------------------------------

    def heap_name(self, heap: int, offset: int, obj: str) -> str:
        self.sig(heap, b'HEAP', obj)
        data = self.addr(heap + 8 + 2 * self.L)
        return self.cstr(data + offset).decode('utf-8')

    def symbol_table(self, btree: int, heap: int,
                     obj: str) -> Iterator[Tuple[str, int]]:
        """(name, object header address) of each entry of a group's
        B-tree, in name order."""
        self.sig(btree, b'TREE', obj)
        if self.u8(btree + 4) != 0:
            self.fail(obj, f'B-tree of type {self.u8(btree + 4)} for a group')
        level, used = self.u8(btree + 5), self.u16(btree + 6)
        pos = btree + 8 + 2 * self.O + self.L        # past key 0
        for i in range(used):
            child = self.addr(pos + i * (self.O + self.L))
            if level > 0:
                yield from self.symbol_table(child, heap, obj)
                continue
            self.sig(child, b'SNOD', obj)
            entry = 2 * self.O + 24
            for j in range(self.u16(child + 6)):
                e = child + 8 + j * entry
                name = self.heap_name(heap, self.length(e), obj)
                if self.u32(e + 2 * self.O) == 2:
                    self.fail(f'{obj}/{name}', 'soft link')
                yield name, self.addr(e + self.O)

class AttributeManager:
    """The attributes of an object, read-only, as a mapping."""

    def __init__(self, items: Dict[str, object]):
        self._items = items

    def __getitem__(self, name):
        return self._items[name]

    def __contains__(self, name):
        return name in self._items

    def __iter__(self):
        return iter(self._items)

    def __len__(self):
        return len(self._items)

    def get(self, name, default=None):
        return self._items.get(name, default)

    def keys(self):
        return self._items.keys()

    def items(self):
        return self._items.items()


class _Object:
    def __init__(self, image: _Image, addr: int, name: str, msgs):
        self._image = image
        self._addr = addr
        self.name = name
        attrs = {}
        for mtype, _, body in msgs:
            if mtype == _ATTRIBUTE:
                key, value = image.attribute(body, name)
                attrs[key] = value
            elif mtype == _ATTRIBUTE_INFO:
                flags = image.u8(body + 1)
                heap = image.addr(body + 2 + (2 if flags & 1 else 0))
                if heap != UNDEF:
                    image.fail(name, 'dense attribute storage (fractal heap)')
        self.attrs = AttributeManager(attrs)


class Dataset(_Object):
    """A dataset: `np.asarray(ds)` or `ds[()]` reads it."""

    def __init__(self, image: _Image, addr: int, name: str, msgs):
        super().__init__(image, addr, name, msgs)
        found = {t: body for t, _, body in msgs}
        if _FILTERS in found:
            image.fail(name, 'filter pipeline (compression, shuffle, '
                       'checksum)')
        if _EXTERNAL in found:
            image.fail(name, 'data in external files')
        self._dtype = image.datatype(found[_DATATYPE], name)
        shape = image.dataspace(found[_DATASPACE], name)
        self.shape = () if shape is None else shape
        self._null = shape is None
        p = found[_LAYOUT]
        version = image.u8(p)
        if version in (3, 4):
            cls = image.u8(p + 1)
            if cls == 0:
                self._data = p + 4
            elif cls == 1:
                self._data = image.addr(p + 2)
            else:
                image.fail(name, f"{'chunked' if cls == 2 else 'virtual'} "
                           'dataset layout')
        elif version in (1, 2):
            rank, cls = image.u8(p + 1), image.u8(p + 2)
            if cls == 0:
                self._data = p + 8 + 4 * rank + 4
            elif cls == 1:
                self._data = image.addr(p + 8)
            else:
                image.fail(name, 'chunked dataset layout')
        else:
            image.fail(name, f'data layout version {version}')
        if self._data == UNDEF and not self._null:
            image.fail(name, 'dataset with no storage allocated')

    @property
    def dtype(self):
        kind, info = self._dtype
        if kind == 'num':
            return info.newbyteorder('=')
        return np.dtype(f'S{info}') if kind == 'str' else np.dtype(object)

    def read(self):
        if self._null:
            return None
        return self._image.values(self._dtype, self.shape, self._data,
                                  self.name)

    def __getitem__(self, key):
        value = self.read()
        if key == () or key is Ellipsis:
            return value
        return np.asarray(value)[key]

    def __array__(self, dtype=None, copy=None):
        a = np.asarray(self.read())
        return a if dtype is None else a.astype(dtype)


class Group(_Object):
    """A group: a read-only mapping of names to groups and datasets."""

    def __init__(self, image: _Image, addr: int, name: str, msgs):
        super().__init__(image, addr, name, msgs)
        self._links: Dict[str, int] = {}
        for mtype, _, body in msgs:
            if mtype == _SYMBOL_TABLE:
                btree, heap = image.addr(body), image.addr(body + image.O)
                self._links.update(image.symbol_table(btree, heap, name))
            elif mtype in (_LINK, _LINK_INFO):
                image.fail(name, 'a group of link messages (libver '
                           '"latest"), not a symbol table')

    def keys(self):
        return list(self._links)

    def __iter__(self):
        return iter(self._links)

    def __len__(self):
        return len(self._links)

    def __contains__(self, path):
        try:
            self[path]
        except KeyError:
            return False
        return True

    def items(self):
        return [(k, self[k]) for k in self._links]

    def __getitem__(self, path: str):
        node = self
        for part in [p for p in path.split('/') if p]:
            if not isinstance(node, Group) or part not in node._links:
                raise KeyError(f'{path!r} not in {self.name!r}')
            node = _open(node._image, node._links[part],
                         node.name.rstrip('/') + '/' + part)
        return node


def _open(image: _Image, addr: int, name: str):
    msgs = image.messages(addr, name)
    types = {t for t, _, _ in msgs}
    if _LAYOUT in types:
        return Dataset(image, addr, name, msgs)
    if types & {_SYMBOL_TABLE, _LINK, _LINK_INFO}:
        return Group(image, addr, name, msgs)
    image.fail(name, f'object that is neither a group nor a dataset '
               f'(messages {sorted(types)})')


class File(Group):
    """An HDF5 file: `File(path)` reads it (the root group), `File(path,
    'w')` starts an empty one that is written on close()."""

    def __new__(cls, path: str, mode: str = 'r'):
        if mode == 'w':
            return _WFile(path)
        if mode != 'r':
            raise ValueError(f"mode must be 'r' or 'w', got {mode!r}")
        return super().__new__(cls)

    def __init__(self, path: str, mode: str = 'r'):
        with open(path, 'rb') as f:
            image = _Image(path, f.read())
        super().__init__(image, image.root_header, '/',
                         image.messages(image.root_header, '/'))

    def close(self):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# --------------------------------------------------------------------------
# writer

_LEAF_K, _NODE_K = 4, 16            # HDF5's defaults for groups
_O = _L = 8


class _WDataset:
    def __init__(self, data: np.ndarray):
        self.data = data
        self.attrs: Dict[str, object] = {}


class _WGroup:
    def __init__(self):
        self.children: Dict[str, object] = {}
        self.attrs: Dict[str, object] = {}

    def _parent_of(self, path: str) -> Tuple['_WGroup', str]:
        parts = [p for p in path.split('/') if p]
        if not parts:
            raise ValueError(f'empty name {path!r}')
        node = self
        for part in parts[:-1]:
            node = node.children.setdefault(part, _WGroup())
            if not isinstance(node, _WGroup):
                raise ValueError(f'{part!r} of {path!r} is a dataset')
        if parts[-1] in node.children:
            raise ValueError(f'{path!r} exists')
        return node, parts[-1]

    def create_group(self, path: str) -> '_WGroup':
        parent, name = self._parent_of(path)
        g = parent.children[name] = _WGroup()
        return g

    def create_dataset(self, path: str, data) -> _WDataset:
        """A contiguous dataset of `data` (ints, floats), little-endian;
        '/' in `path` makes the groups between."""
        a = np.ascontiguousarray(data)
        if a.dtype.kind not in 'iuf':
            raise TypeError(f'{path}: dataset of dtype {a.dtype} (numbers '
                            'only)')
        parent, name = self._parent_of(path)
        ds = parent.children[name] = _WDataset(a.astype(a.dtype.newbyteorder(
            '<')))
        return ds


def _w_datatype(dtype: np.dtype) -> bytes:
    size = dtype.itemsize
    if dtype.kind == 'f':
        if size not in _IEEE:
            raise TypeError(f'float of {size} bytes')
        eloc, esize, msize, bias = _IEEE[size]
        bits = (0x20, 8 * size - 1, 0)      # implied mantissa bit, sign
        return (struct.pack('<B3BI', 0x11, *bits, size)
                + struct.pack('<HHBBBBI', 0, 8 * size, eloc, esize, 0, msize,
                              bias))
    if dtype.kind in 'iu':
        bits = (0x08 if dtype.kind == 'i' else 0, 0, 0)
        return (struct.pack('<B3BI', 0x10, *bits, size)
                + struct.pack('<HH', 0, 8 * size))
    if dtype.kind == 'S':
        return struct.pack('<B3BI', 0x13, 0x01, 0, 0, size)   # null-padded
    raise TypeError(f'no HDF5 datatype written for {dtype}')


def _w_dataspace(shape) -> bytes:
    return (struct.pack('<BBBBI', 1, len(shape), 0, 0, 0)
            + b''.join(struct.pack('<Q', n) for n in shape))


def _attr_array(name: str, value) -> np.ndarray:
    if isinstance(value, str):
        raise TypeError(f'attribute {name!r}: str values are not written '
                        '(give bytes)')
    if isinstance(value, (bytes, np.bytes_)):
        return np.array(value, dtype=f'S{max(1, len(value))}')
    a = np.asarray(value)
    if a.dtype.kind == 'S':
        return a if a.itemsize else a.astype('S1')
    if a.dtype.kind not in 'iuf':
        raise TypeError(f'attribute {name!r} of dtype {a.dtype}')
    return a.astype(a.dtype.newbyteorder('<'))


def _w_attribute(name: str, value) -> bytes:
    a = _attr_array(name, value)
    bname = name.encode('utf-8') + b'\0'
    dt, ds = _w_datatype(a.dtype), _w_dataspace(a.shape)
    body = (struct.pack('<BBHHH', 1, 0, len(bname), len(dt), len(ds))
            + bname.ljust(_pad8(len(bname)), b'\0')
            + dt.ljust(_pad8(len(dt)), b'\0')
            + ds.ljust(_pad8(len(ds)), b'\0')
            + np.ascontiguousarray(a).tobytes())
    return body


class _Writer:
    def __init__(self):
        self.buf = bytearray(96)        # the superblock, written last

    def alloc(self, data: bytes) -> int:
        addr = len(self.buf)
        self.buf += data
        self.buf += b'\0' * (_pad8(len(self.buf)) - len(self.buf))
        return addr

    def header(self, msgs: List[Tuple[int, bytes]]) -> int:
        """A version-1 object header of (type, body) messages, in one
        block."""
        block = b''.join(struct.pack('<HHB3x', t, _pad8(len(b)), 0)
                         + b.ljust(_pad8(len(b)), b'\0') for t, b in msgs)
        for t, b in msgs:
            if _pad8(len(b)) > 0xFFFF:
                raise ValueError(f'object header message of {len(b)} bytes '
                                 '(at most 65535)')
        return self.alloc(struct.pack('<BBHII4x', 1, 0, len(msgs), 1,
                                      len(block)) + block)

    def attributes(self, attrs) -> List[Tuple[int, bytes]]:
        return [(_ATTRIBUTE, _w_attribute(k, v)) for k, v in attrs.items()]

    def dataset(self, ds: _WDataset) -> int:
        a = ds.data
        addr = self.alloc(a.tobytes())
        layout = struct.pack('<BBQQ', 3, 1, addr, a.nbytes)
        fill = struct.pack('<BBBB', 2, 2, 2, 0)   # late, if set, undefined
        return self.header([(_DATASPACE, _w_dataspace(a.shape)),
                            (_DATATYPE, _w_datatype(a.dtype)),
                            (_FILL, fill), (_LAYOUT, layout)]
                           + self.attributes(ds.attrs))

    def group(self, g: _WGroup) -> Tuple[int, int, int]:
        """Write `g` and its subtree: (header, B-tree, local heap)."""
        entries = []
        for name, child in g.children.items():
            if isinstance(child, _WGroup):
                h, bt, hp = self.group(child)
                entries.append((name.encode('utf-8'), h, (bt, hp)))
            else:
                entries.append((name.encode('utf-8'), self.dataset(child),
                                None))
        entries.sort(key=lambda e: e[0])
        # local heap: "" at 0, then each name, 8-byte aligned
        data, offsets = bytearray(8), {}
        for name, _, _ in entries:
            offsets[name] = len(data)
            data += name + b'\0'
            data += b'\0' * (_pad8(len(data)) - len(data))
        data_addr = self.alloc(bytes(data))
        heap = self.alloc(b'HEAP' + struct.pack('<B3xQQQ', 0, len(data), 1,
                                                data_addr))
        # symbol-table nodes of up to 2*leaf K entries
        nodes = []
        cap = 2 * _LEAF_K
        for i in range(0, max(len(entries), 1), cap):
            chunk = entries[i:i + cap]
            body = bytearray(b'SNOD' + struct.pack('<BxH', 1, len(chunk)))
            for name, h, cache in chunk:
                if cache is None:
                    body += struct.pack('<QQII16x', offsets[name], h, 0, 0)
                else:
                    body += struct.pack('<QQII', offsets[name], h, 1, 0) \
                        + struct.pack('<QQ', *cache)
            body += b'\0' * (8 + cap * 40 - len(body))
            last = offsets[chunk[-1][0]] if chunk else 0
            nodes.append((self.alloc(bytes(body)), last))
        # B-tree levels of up to 2*node K children, keyed by the last name
        # below each child
        level = 0
        while True:
            parents = []
            cap = 2 * _NODE_K
            groups = [nodes[i:i + cap] for i in range(0, len(nodes), cap)]
            lows = [0] + [grp[-1][1] for grp in groups[:-1]]
            addrs = []
            for grp, low in zip(groups, lows):
                used = len(grp) if entries else 0
                body = bytearray(b'TREE' + struct.pack('<BBH', 0, level, used)
                                 + struct.pack('<QQ', UNDEF, UNDEF))
                body += struct.pack('<Q', low)
                for child, key in grp[:used]:
                    body += struct.pack('<QQ', child, key)
                body += b'\0' * (8 + 2 * _O + cap * _O + (cap + 1) * _L
                                 - len(body))
                addrs.append(self.alloc(bytes(body)))
                parents.append((addrs[-1], grp[-1][1]))
            for i, a in enumerate(addrs):   # siblings
                left = addrs[i - 1] if i else UNDEF
                right = addrs[i + 1] if i + 1 < len(addrs) else UNDEF
                self.buf[a + 8:a + 24] = struct.pack('<QQ', left, right)
            if len(parents) == 1:
                btree = parents[0][0]
                break
            nodes, level = parents, level + 1
        header = self.header([(_SYMBOL_TABLE, struct.pack('<QQ', btree, heap))]
                             + self.attributes(g.attrs))
        return header, btree, heap

    def finish(self, root: _WGroup) -> bytes:
        header, btree, heap = self.group(root)
        sb = (SIGNATURE + struct.pack('<BBBBBBBBHHI', 0, 0, 0, 0, 0, _O, _L,
                                      0, _LEAF_K, _NODE_K, 0)
              + struct.pack('<QQQQ', 0, UNDEF, len(self.buf), UNDEF)
              + struct.pack('<QQII', 0, header, 1, 0)
              + struct.pack('<QQ', btree, heap))
        self.buf[:len(sb)] = sb
        return bytes(self.buf)


class _WFile(_WGroup):
    """A file being written: groups, datasets and attributes as h5py
    makes them; the bytes go out on close()."""

    def __init__(self, path: str):
        super().__init__()
        self.path = path
        self._closed = False

    def close(self):
        if self._closed:
            return
        data = _Writer().finish(self)
        with open(self.path, 'wb') as f:
            f.write(data)
        self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *exc):
        if exc_type is None:
            self.close()
