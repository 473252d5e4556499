"""The OCDBT key-value store (tensorstore's `ocdbt` driver over a
directory) in the layout Orbax writes, read and written by the port's own
code.

A database is a directory with `manifest.ocdbt` and data files under
`d/`. Every manifest and B-tree node is one file region:

    magic u32 big-endian | length u64 | version varint (0)
    | compression varint (0 none, 1 zstd) | body | CRC-32C u32 of the rest

(integers little-endian unless said, varints LEB128). The manifest body
holds the configuration, a table of data files, the newest versions
inline and references to version-tree nodes for older ones; a version
names its B-tree root (data file, offset, length, height). A B-tree node
holds its own data-file table and its entries column by column: keys
prefix-compressed against the previous key, and then, in a leaf, each
value inline or as a reference (data file, offset, length); in an
interior node, each child's reference and the length of the key prefix
that all of the child's keys share, which the child's keys leave out.
Data-file paths are relative to the database that names them: Orbax's
root database points into `ocdbt.process_0/`, where the large values sit.

    Database(path)                    .keys(), .get(key), .versions()
    write_db(path, items)             {key: bytes}, the layout Orbax writes:
                                      the values, a manifest and a leaf in
                                      `ocdbt.process_0/`, and a root manifest
                                      and a leaf that point into it

The writer stores no compressed node (compression 0 in every header and in
the configuration) and puts every key in one leaf, as Orbax's trees fit
in one node (a leaf above MAX_DECODED_NODE_BYTES raises). Manifests with numbered versions (`manifest_kind` 1)
raise; Orbax writes single-file manifests.
"""

from __future__ import annotations

import os
import struct
import time
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Tuple

from ursonet_torch.checkpoint import zstd

MANIFEST_MAGIC = 0x0CDB3A2A
BTREE_MAGIC = 0x0CDB20DE
VERSION_MAGIC = 0x0CDB1234
MANIFEST = 'manifest.ocdbt'
PROCESS_DB = 'ocdbt.process_0'
# Orbax's configuration: values above 1 KiB go to a data file
MAX_INLINE_VALUE_BYTES = 1024
MAX_DECODED_NODE_BYTES = 100_000_000
VERSION_TREE_ARITY_LOG2 = 4


# ---------------------------------------------------------------------------
# encoding


class _Body:
    """Cursor over a decoded body; faults name the file and the offset."""

    def __init__(self, data: bytes, where: str):
        self.b = memoryview(data)
        self.pos = 0
        self.where = where

    def fail(self, what: str):
        raise ValueError(f'OCDBT {self.where}: at body byte {self.pos}: {what}')

    def varint(self) -> int:
        v, shift = 0, 0
        while True:
            if self.pos >= len(self.b):
                self.fail('varint runs past the end')
            c = self.b[self.pos]
            self.pos += 1
            v |= (c & 0x7F) << shift
            if not c & 0x80:
                return v
            shift += 7
            if shift > 63:
                self.fail('varint longer than 64 bits')

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.b):
            self.fail(f'{n} bytes run past the end')
        out = bytes(self.b[self.pos:self.pos + n])
        self.pos += n
        return out

    def u8s(self, n: int) -> List[int]:
        return list(self.take(n))

    def u64s(self, n: int) -> List[int]:
        return list(struct.unpack(f'<{n}Q', self.take(8 * n)))

    def end(self):
        if self.pos != len(self.b):
            self.fail(f'{len(self.b) - self.pos} bytes after the last field')


def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        c = v & 0x7F
        v >>= 7
        if v:
            out.append(c | 0x80)
        else:
            out.append(c)
            return bytes(out)


def _varints(vs: Iterable[int]) -> bytes:
    return b''.join(_varint(v) for v in vs)


def _decode_region(data: bytes, magic: int, where: str) -> bytes:
    """Checks a manifest's or node's header and CRC; returns its body."""
    if len(data) < 18:
        raise ValueError(f'OCDBT {where}: {len(data)} bytes is too short')
    got, length = struct.unpack('>IQ', data[:4] + data[4:12][::-1])
    if got != magic:
        raise ValueError(f'OCDBT {where}: magic {got:#010x}, expected '
                         f'{magic:#010x}')
    if length != len(data):
        raise ValueError(f'OCDBT {where}: header says {length} bytes, the '
                         f'region has {len(data)}')
    crc = struct.unpack('<I', data[-4:])[0]
    if zstd.crc32c(data[:-4]) != crc:
        raise ValueError(f'OCDBT {where}: CRC-32C mismatch')
    head = _Body(data[12:-4], where)
    if head.varint() != 0:
        head.fail('unknown format version')
    comp = head.varint()
    rest = bytes(head.b[head.pos:])
    if comp == 0:
        return rest
    if comp == 1:
        return zstd.decompress(rest)
    head.fail(f'unknown compression {comp}')


def _encode_region(magic: int, body: bytes) -> bytes:
    """Header (compression 0), body and CRC-32C."""
    head = _varint(0) + _varint(0)
    length = 4 + 8 + len(head) + len(body) + 4
    data = struct.pack('>I', magic) + struct.pack('<Q', length) + head + body
    return data + struct.pack('<I', zstd.crc32c(data))


def _read_data_files(b: _Body) -> List[str]:
    n = b.varint()
    prefix = [0] + b.varints(max(n - 1, 0))
    suffix = b.varints(n)
    base = b.varints(n)
    paths, prev = [], b''
    for i in range(n):
        if prefix[i] > len(prev) or base[i] > prefix[i] + suffix[i]:
            b.fail('data-file table out of bounds')
        prev = prev[:prefix[i]] + b.take(suffix[i])
        paths.append(prev.decode())
    return paths


def _write_data_files(paths: List[str], base_lens: List[int]) -> bytes:
    enc = [p.encode() for p in paths]
    prefix = [_common(enc[i - 1], enc[i]) for i in range(1, len(enc))]
    suffix = [len(e) - p for e, p in zip(enc, [0] + prefix)]
    return (_varint(len(enc)) + _varints(prefix) + _varints(suffix)
            + _varints(base_lens)
            + b''.join(e[p:] for e, p in zip(enc, [0] + prefix)))


def _common(a: bytes, b: bytes) -> int:
    n = min(len(a), len(b))
    i = 0
    while i < n and a[i] == b[i]:
        i += 1
    return i


def _read_keys(b: _Body, n: int, with_subtree: bool):
    prefix = [0] + b.varints(max(n - 1, 0))
    suffix = b.varints(n)
    subtree = b.varints(n) if with_subtree else None
    keys, prev = [], b''
    for i in range(n):
        if prefix[i] > len(prev):
            b.fail('key prefix longer than the previous key')
        prev = prev[:prefix[i]] + b.take(suffix[i])
        keys.append(prev)
    return keys, subtree


def _write_keys(keys: List[bytes], subtree: Optional[List[int]] = None
                ) -> bytes:
    prefix = [_common(keys[i - 1], keys[i]) for i in range(1, len(keys))]
    suffix = [len(k) - p for k, p in zip(keys, [0] + prefix)]
    out = _varint(len(keys)) + _varints(prefix) + _varints(suffix)
    if subtree is not None:
        out += _varints(subtree)
    return out + b''.join(k[p:] for k, p in zip(keys, [0] + prefix))


# ---------------------------------------------------------------------------
# reading


@dataclass
class Ref:
    """A region of a data file; `path` relative to the database root."""
    path: str
    offset: int
    length: int


@dataclass
class Version:
    generation: int
    root: Optional[Ref]
    root_height: int
    num_keys: int
    commit_time_ns: int


class Database:
    """A read-only view of one OCDBT database at its newest version."""

    def __init__(self, root: str):
        self.root = root
        body = self._region(os.path.join(root, MANIFEST), MANIFEST_MAGIC,
                            MANIFEST)
        b = _Body(body, os.path.join(root, MANIFEST))
        b.take(16)                  # the database's uuid
        kind = b.varint()
        if kind != 0:
            b.fail(f'manifest_kind {kind}: numbered manifests are not '
                   'supported')
        b.varints(2)                # max inline value, max node bytes
        b.u8s(1)                    # version tree arity, log2
        comp = b.varint()           # for nodes written later
        if comp == 1:
            b.take(4)               # zstd level, int32
        elif comp != 0:
            b.fail(f'unknown compression method {comp}')
        files = _read_data_files(b)
        self._inline = self._read_versions(b, files)
        self._version_nodes = self._read_version_refs(b, files)
        b.end()
        self._entries: Optional[Dict[bytes, Tuple[Optional[bytes],
                                                  Optional[Ref]]]] = None

    # -- files

    def _read(self, ref: Ref) -> bytes:
        path = os.path.join(self.root, ref.path)
        with open(path, 'rb') as f:
            f.seek(ref.offset)
            data = f.read(ref.length)
        if len(data) != ref.length:
            raise ValueError(f'OCDBT {path}: {ref.length} bytes at '
                             f'{ref.offset} run past its end')
        return data

    def _region(self, path: str, magic: int, where: str) -> bytes:
        with open(path, 'rb') as f:
            return _decode_region(f.read(), magic, where)

    # -- versions

    @staticmethod
    def _ref(b: _Body, files: List[str], fid: int, off: int, ln: int) -> Ref:
        if fid >= len(files):
            b.fail(f'data file {fid} of {len(files)}')
        return Ref(files[fid], off, ln)

    def _read_versions(self, b: _Body, files) -> List[Version]:
        n = b.varint()
        gen = b.varints(n)
        root_height = b.u8s(n)
        fid, off, ln = b.varints(n), b.varints(n), b.varints(n)
        num_keys = b.varints(n)
        b.varints(n)   # num_tree_bytes
        b.varints(n)   # num_indirect_value_bytes
        t = b.u64s(n)
        return [Version(gen[i], self._ref(b, files, fid[i], off[i], ln[i])
                        if num_keys[i] or ln[i] else None,
                        root_height[i], num_keys[i], t[i]) for i in range(n)]

    def _read_version_refs(self, b: _Body, files, height: Optional[int] = None
                           ) -> List[Tuple[int, Ref]]:
        """(height, ref) of version-tree nodes: the manifest carries each
        node's height, an interior node's children are one lower."""
        n = b.varint()
        b.varints(n)                                    # generation
        fid, off, ln = b.varints(n), b.varints(n), b.varints(n)
        b.varints(n)                                    # num_generations
        b.u64s(n)                                       # commit time
        heights = b.u8s(n) if height is None else [height] * n
        return [(heights[i], self._ref(b, files, fid[i], off[i], ln[i]))
                for i in range(n)]

    def versions(self) -> List[Version]:
        """Every version, oldest first (version-tree nodes, then the ones
        the manifest holds inline)."""
        out = []

        def walk(height: int, ref: Ref):
            where = f'{ref.path}@{ref.offset}'
            b = _Body(_decode_region(self._read(ref), VERSION_MAGIC, where),
                      where)
            b.u8s(1)                                    # arity log2
            h = b.u8s(1)[0]
            if h != height:
                b.fail(f'version node of height {h}, expected {height}')
            files = _read_data_files(b)
            if h == 0:
                out.extend(self._read_versions(b, files))
                b.end()
                return
            children = self._read_version_refs(b, files, height=h - 1)
            b.end()
            for ch, r in children:
                walk(ch, r)

        for h, ref in self._version_nodes:
            walk(h, ref)
        return out + self._inline

    @property
    def latest(self) -> Version:
        if not self._inline:
            raise ValueError(f'OCDBT {self.root}: the manifest holds no '
                             'version')
        return self._inline[-1]

    # -- the B-tree

    def _load(self):
        v = self.latest
        self._entries = {}
        if v.root is not None:
            self._walk(v.root, v.root_height, b'')
        if len(self._entries) != v.num_keys:
            raise ValueError(f'OCDBT {self.root}: {len(self._entries)} keys, '
                             f'the version says {v.num_keys}')

    def _walk(self, ref: Ref, height: int, prefix: bytes):
        where = f'{ref.path}@{ref.offset}'
        b = _Body(_decode_region(self._read(ref), BTREE_MAGIC, where), where)
        h = b.u8s(1)[0]
        if h != height:
            b.fail(f'node of height {h}, expected {height}')
        files = _read_data_files(b)
        n = b.varint()
        keys, subtree = _read_keys(b, n, with_subtree=h > 0)
        if h > 0:
            fid, off, ln = b.varints(n), b.varints(n), b.varints(n)
            b.varints(n)   # num_keys
            b.varints(n)   # num_tree_bytes
            b.varints(n)   # num_indirect_value_bytes
            b.end()
            for i in range(n):
                self._walk(self._ref(b, files, fid[i], off[i], ln[i]), h - 1,
                           prefix + keys[i][:subtree[i]])
            return
        lengths = b.varints(n)
        kinds = b.varints(n)
        indirect = [i for i in range(n) if kinds[i] == 1]
        if any(k not in (0, 1) for k in kinds):
            b.fail('unknown value kind')
        fid = b.varints(len(indirect))
        off = b.varints(len(indirect))
        refs = {i: self._ref(b, files, f, o, lengths[i])
                for i, f, o in zip(indirect, fid, off)}
        for i in range(n):
            key = prefix + keys[i]
            if key in self._entries:
                b.fail(f'key {key!r} twice')
            if i in refs:
                self._entries[key] = (None, refs[i])
            else:
                self._entries[key] = (b.take(lengths[i]), None)
        b.end()

    def keys(self) -> List[str]:
        if self._entries is None:
            self._load()
        return sorted(k.decode() for k in self._entries)

    def get(self, key: str) -> Optional[bytes]:
        """The value of `key`, None where there is none."""
        if self._entries is None:
            self._load()
        entry = self._entries.get(key.encode())
        if entry is None:
            return None
        inline, ref = entry
        return inline if ref is None else self._read(ref)


# ---------------------------------------------------------------------------
# writing


def _write_one(root: str, items: Dict[bytes, Tuple[bytes, Optional[Ref]]],
               data_name: str) -> None:
    """One database in `root`: its B-tree, one leaf, appended to the data
    file `d/<data_name>`, and a manifest. `items`: key -> (inline value,
    or b'' and the Ref of an indirect one)."""
    data_rel = f'd/{data_name}'
    data_path = os.path.join(root, data_rel)
    os.makedirs(os.path.dirname(data_path), exist_ok=True)
    head = os.path.getsize(data_path) if os.path.exists(data_path) else 0
    keys = sorted(items)
    refs = [items[k][1] for k in keys]
    # the data files the indirect values name, each with its base path
    # (the directory before `d/`)
    files = sorted({r.path for r in refs if r is not None})
    fid = {p: i for i, p in enumerate(files)}
    body = (bytes([0])
            + _write_data_files(files, [p.rindex('d/') for p in files])
            + _write_keys(keys)
            + _varints(r.length if r else len(items[k][0])
                       for k, r in zip(keys, refs))
            + _varints(int(r is not None) for r in refs)
            + _varints(fid[r.path] for r in refs if r is not None)
            + _varints(r.offset for r in refs if r is not None)
            + b''.join(items[k][0] for k, r in zip(keys, refs) if r is None))
    if len(body) > MAX_DECODED_NODE_BYTES:
        raise ValueError(f'OCDBT {root}: a leaf of {len(body)} bytes is '
                         f'above the {MAX_DECODED_NODE_BYTES} a node may hold')
    leaf = _encode_region(BTREE_MAGIC, body)
    with open(data_path, 'ab') as f:
        f.write(leaf)
        f.flush()
        os.fsync(f.fileno())

    indirect = sum(r.length for r in refs if r is not None)
    config = (os.urandom(16) + _varint(0) + _varint(MAX_INLINE_VALUE_BYTES)
              + _varint(MAX_DECODED_NODE_BYTES)
              + bytes([VERSION_TREE_ARITY_LOG2]) + _varint(0))
    # one version: generation 1, a root of height 0, no version-tree node
    version = (_varint(1) + _varint(1) + bytes([0]) + _varint(0)
               + _varint(head) + _varint(len(leaf)) + _varint(len(keys))
               + _varint(len(leaf)) + _varint(indirect)
               + struct.pack('<Q', time.time_ns()) + _varint(0))
    manifest = _encode_region(
        MANIFEST_MAGIC,
        config + _write_data_files([data_rel], [0]) + version)
    with open(os.path.join(root, MANIFEST), 'wb') as f:
        f.write(manifest)
        f.flush()
        os.fsync(f.fileno())


def write_db(root: str, items: Dict[str, bytes]) -> None:
    """Write `items` as a new OCDBT database in the directory `root` in
    Orbax's layout: values above MAX_INLINE_VALUE_BYTES in one data file
    of `ocdbt.process_0/`, that database's leaf and manifest, and the root
    database's leaf (in `d/`) and manifest, which name the same values
    through `ocdbt.process_0/d/...`."""
    proc = os.path.join(root, PROCESS_DB)
    name = os.urandom(16).hex()
    data_rel = f'd/{name}'
    os.makedirs(os.path.join(proc, 'd'), exist_ok=True)
    local, pos = {}, 0
    with open(os.path.join(proc, data_rel), 'wb') as f:
        for k in sorted(items):
            v = bytes(items[k])
            if len(v) > MAX_INLINE_VALUE_BYTES:
                f.write(v)
                local[k.encode()] = (b'', Ref(data_rel, pos, len(v)))
                pos += len(v)
            else:
                local[k.encode()] = (v, None)
    _write_one(proc, local, name)
    shared = {k: (v, r if r is None else
                  Ref(f'{PROCESS_DB}/{r.path}', r.offset, r.length))
              for k, (v, r) in local.items()}
    _write_one(root, shared, os.urandom(16).hex())
