"""The port's Orbax store on its own codecs (`ursonet_torch/csrc/zstd.cpp`,
`checkpoint/{zstd,ocdbt,zarr,orbax_store}.py`) against what the JAX
package writes and reads (orbax, tensorstore, zstandard), on the CPU.

Everything is exact: the decoder gives zstandard's input back byte for
byte, OCDBT keys and values equal tensorstore's, and trees cross the two
packages' Orbax directories bit for bit (dtype, shape and bytes).
"""

import json
import os
import shutil

import numpy as np
import pytest
import tensorstore as ts
import zstandard

import jax

from ursonet_tpu.checkpoint import orbax_store as jorbax
from ursonet_tpu.engine import UrsoNet as JaxUrsoNet
from ursonet_tpu.train.optim import make_optimizer as jax_make_optimizer
from ursonet_torch.checkpoint import ocdbt, orbax_store, store, zarr, zstd
from ursonet_torch.checkpoint.convert import params_from_jax
from make_orbax_fixture import PATH as FIXTURE, fixture_tree
from torch_parity import small_configs

# --------------------------------------------------------------------------
# the zstd decoder


def _inputs():
    rng = np.random.default_rng(0)
    text = b''.join(b'%d: the quick brown fox jumps over the lazy dog %d\n'
                    % (i, i * i % 977) for i in range(2000))
    return {
        'f32': rng.standard_normal(30000).astype(np.float32).tobytes(),
        'zeros': bytes(70000),
        'text': text[:60000],
        'empty': b'',
        # above 128 KiB: several blocks, tables repeated between them
        'multiblock': text * 2 + rng.integers(0, 16, 100000, np.uint8)
        .tobytes(),
    }


INPUTS = _inputs()
LEVELS = (1, 3, 19, -5)


@pytest.mark.parametrize('name', sorted(INPUTS))
@pytest.mark.parametrize('checksum', (False, True))
@pytest.mark.parametrize('level', LEVELS)
def test_decoder_matches_zstandard(level, checksum, name):
    data = INPUTS[name]
    frame = zstandard.ZstdCompressor(level=level,
                                     write_checksum=checksum).compress(data)
    assert zstd.decompress(frame) == data


def test_decoder_streamed_and_concatenated_frames():
    """Frames without a content size (as tensorstore writes them),
    several frames in one buffer, and a skippable frame between them."""
    frames, want = [], b''
    for level, name in ((1, 'f32'), (19, 'multiblock'), (-5, 'text')):
        c = zstandard.ZstdCompressor(level=level, write_content_size=False)
        obj = c.compressobj()
        frames.append(obj.compress(INPUTS[name]) + obj.flush())
        want += INPUTS[name]
    frames.insert(1, (0x184D2A53).to_bytes(4, 'little')
                  + (5).to_bytes(4, 'little') + b'hello')
    assert zstandard.get_frame_parameters(frames[0]).content_size == \
        zstandard.CONTENTSIZE_UNKNOWN
    assert zstd.decompress(b''.join(frames)) == want


@pytest.mark.parametrize('name', sorted(INPUTS))
def test_frame_raw_read_by_zstandard(name):
    data = INPUTS[name]
    frame = zstd.frame_raw(data)
    params = zstandard.get_frame_parameters(frame)
    assert params.content_size == len(data)
    assert zstandard.ZstdDecompressor().decompress(frame) == data
    assert zstd.decompress(frame) == data


def _corrupt(case):
    good = zstandard.ZstdCompressor(level=3, write_checksum=True).compress(
        INPUTS['text'])
    if case == 'truncated':
        return good[:len(good) // 2]
    if case == 'checksum':
        return good[:-1] + bytes([good[-1] ^ 1])
    if case == 'flipped byte':
        b = bytearray(good)
        b[len(b) // 2] ^= 0x40
        return bytes(b)
    if case == 'magic':
        return b'\x29' + good[1:]
    if case == 'reserved bit':
        return good[:4] + bytes([good[4] | 8]) + good[5:]
    if case == 'dictionary':
        d = zstandard.train_dictionary(
            1024, [b'frame %d of a sample %d' % (i, i * 7)
                   for i in range(2000)])
        return zstandard.ZstdCompressor(dict_data=d).compress(b'frame 5')
    if case == 'empty':
        return b''
    raise ValueError(case)


@pytest.mark.parametrize('case', ('truncated', 'checksum', 'flipped byte',
                                  'magic', 'reserved bit', 'dictionary',
                                  'empty'))
def test_corrupt_frame_raises(case):
    with pytest.raises(ValueError, match=r'zstd: at byte \d+'):
        zstd.decompress(_corrupt(case))


def test_checksums_known_values():
    assert zstd.crc32c(b'123456789') == 0xE3069283
    assert zstd.crc32c(b'') == 0
    assert zstd.crc32c(b'6789', zstd.crc32c(b'12345')) == 0xE3069283


# --------------------------------------------------------------------------
# OCDBT and zarr against tensorstore


def _ts_keys(path):
    kv = ts.KvStore.open({'driver': 'ocdbt',
                          'base': f'file://{os.path.abspath(path)}/'}
                         ).result()
    return sorted(k.decode() for k in kv.list().result())


def _ts_items(path):
    kv = ts.KvStore.open({'driver': 'ocdbt',
                          'base': f'file://{os.path.abspath(path)}/'}
                         ).result()
    return {k.decode(): kv.read(k).result().value
            for k in kv.list().result()}


def test_ocdbt_reads_tensorstore(tmp_path):
    """tensorstore's writes with small nodes (an interior B-tree of
    several levels), 40 commits (a version-tree node beside the inline
    versions), zstd-compressed nodes, inline and indirect values."""
    path = str(tmp_path / 'db')
    kv = ts.KvStore.open({'driver': 'ocdbt', 'base': f'file://{path}/',
                          'config': {'max_decoded_node_bytes': 300,
                                     'max_inline_value_bytes': 100,
                                     'compression': {'id': 'zstd',
                                                     'level': 3}}}
                         ).result()
    rng = np.random.default_rng(3)
    want = {}
    for i in range(40):
        key = f'params.layer{i % 13:02d}.kernel/{i % 3}'
        want[key] = rng.bytes(int(rng.integers(0, 400)))
        kv.write(key, want[key]).result()
    db = ocdbt.Database(path)
    assert db.latest.root_height >= 2
    assert {k: db.get(k) for k in db.keys()} == _ts_items(path) == want
    assert [v.generation for v in db.versions()] == list(range(1, 42))
    assert db.get('params.missing/0') is None


def test_ocdbt_writer_read_by_tensorstore(tmp_path):
    """The port's database in Orbax's two-level layout: tensorstore lists
    and reads the same items in the root and in `ocdbt.process_0/`."""
    rng = np.random.default_rng(4)
    items = {f'params.l{i:02d}.kernel/{"0.0" if i % 2 else ".zarray"}':
             rng.bytes(int(rng.integers(0, 3000))) for i in range(30)}
    path = str(tmp_path / 'db')
    ocdbt.write_db(path, items)
    assert _ts_items(path) == items
    assert _ts_items(os.path.join(path, ocdbt.PROCESS_DB)) == items
    db = ocdbt.Database(path)
    assert {k: db.get(k) for k in db.keys()} == items


def test_corrupt_node_raises(tmp_path):
    path = str(tmp_path / 'db')
    ocdbt.write_db(path, {'a/0': b'x' * 10})
    man = os.path.join(path, ocdbt.MANIFEST)
    data = bytearray(open(man, 'rb').read())
    data[20] ^= 1
    open(man, 'wb').write(bytes(data))
    with pytest.raises(ValueError, match='CRC-32C'):
        ocdbt.Database(path)


@pytest.mark.parametrize('dtype', ('<f4', '<i4', '<i8', '<f2', '|u1'))
def test_zarr_reads_tensorstore_chunk_grid(tmp_path, dtype):
    """A 3x2 chunk grid with edge chunks, only part of it written: the
    missing chunks read as the fill value."""
    path = str(tmp_path / 'db')
    arr = ts.open({'driver': 'zarr', 'path': 'x.y',
                   'kvstore': {'driver': 'ocdbt', 'base': f'file://{path}/'},
                   'metadata': {'shape': [10, 7], 'chunks': [4, 4],
                                'dtype': dtype,
                                'compressor': {'id': 'zstd', 'level': 5},
                                'dimension_separator': '.'},
                   'create': True}).result()
    rng = np.random.default_rng(5)
    part = (rng.standard_normal((8, 4)) * 50).astype(dtype)
    arr[:8, :4] = part
    want = np.zeros((10, 7), dtype)
    want[:8, :4] = part
    db = ocdbt.Database(path)
    assert [k for k in db.keys() if not k.endswith('.zarray')] == \
        ['x.y/0.0', 'x.y/1.0']
    got = zarr.read_array(db.get, 'x.y')
    assert got.dtype == np.dtype(dtype) and got.tobytes() == want.tobytes()


# --------------------------------------------------------------------------
# the store: JAX-written directories and the port's


def _trees_equal(a, b, path=''):
    if isinstance(a, dict) or isinstance(b, dict):
        assert isinstance(a, dict) and isinstance(b, dict), path
        assert sorted(a) == sorted(b), path
        for k in a:
            _trees_equal(a[k], b[k], f'{path}/{k}')
    elif a is None or b is None:
        assert a is None and b is None, path
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert (a.dtype, a.shape) == (b.dtype, b.shape), path
        assert a.tobytes() == b.tobytes(), path


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


STATE_CASES = {'sgd': {}, 'adam': {'OPTIMIZER': 'ADAM'},
               'adam_clr': {'OPTIMIZER': 'ADAM', 'CLR': True},
               'f16': {'F16': True}, 'train_bn_none': {'TRAIN_BN': None}}


@pytest.fixture(scope='module')
def jax_dirs(tmp_path_factory):
    """Orbax directories the JAX package wrote: weights with and without
    batch_stats, and the train state of each STATE_CASES configuration
    (the JAX engine's own state under F16 and TRAIN_BN=None; SGD, Adam
    and Adam + CLR with every optimizer leaf drawn from a seed)."""
    root = tmp_path_factory.mktemp('jax_orbax')
    rng = np.random.default_rng(6)
    out = {}
    base = None
    for case, kw in STATE_CASES.items():
        jcfg, _ = small_configs(**kw)
        if base is None or case in ('f16', 'train_bn_none'):
            eng = JaxUrsoNet('training', jcfg, str(root / case))
            eng.initialize()
            state = eng.state
            if base is None:
                base = state
        else:
            tx = jax_make_optimizer(jcfg)
            state = base.replace(opt_state=tx.init(base.params))
        state = state.replace(
            step=np.asarray(int(rng.integers(1, 1000)), np.int32),
            opt_state=jax.tree_util.tree_map(
                lambda x: (rng.standard_normal(np.shape(x), np.float32)
                           .astype(np.asarray(x).dtype)
                           if np.asarray(x).dtype.kind == 'f'
                           else np.asarray(int(rng.integers(1, 1000)),
                                           np.asarray(x).dtype)),
                jax.device_get(state.opt_state)))
        path = str(root / f'state_{case}.orbax')
        jorbax.save_state_dir(path, state, epoch=int(rng.integers(1, 99)))
        out[case] = path
    params, stats = _np(base.params), _np(base.batch_stats)
    for name, bs in (('weights_bs', stats), ('weights', None)):
        path = str(root / f'{name}.orbax')
        jorbax.save_weights_dir(path, params, bs)
        out[name] = path
    yield out
    shutil.rmtree(root, ignore_errors=True)


@pytest.mark.parametrize('name', ('weights_bs', 'weights'))
def test_weights_cross_packages(jax_dirs, tmp_path, name):
    """JAX-written weights read bit for bit by the port, the port's read
    bit for bit by the JAX package, and the same keys and metadata in
    both directories."""
    want = jorbax.load_weights_dir(jax_dirs[name])
    got = orbax_store.load_weights_dir(jax_dirs[name])
    _trees_equal(got, want)
    assert (got['batch_stats'] is None) == (name == 'weights')
    mine = str(tmp_path / 'w.orbax')
    orbax_store.save_weights_dir(mine, got['params'], got['batch_stats'])
    _trees_equal(jorbax.load_weights_dir(mine), want)
    assert _ts_keys(mine) == _ts_keys(jax_dirs[name])
    with open(os.path.join(mine, '_METADATA')) as f, \
            open(os.path.join(jax_dirs[name], '_METADATA')) as g:
        assert json.load(f) == json.load(g)
    # the port's state_dict of either directory
    sd = store.load_weights_file(jax_dirs[name])
    ref = params_from_jax(want)
    assert sorted(sd) == sorted(ref)
    assert all(sd[k].numpy().tobytes() == ref[k].numpy().tobytes()
               for k in sd)


@pytest.mark.parametrize('case', sorted(STATE_CASES))
def test_state_cross_packages(jax_dirs, tmp_path, case):
    want = jorbax.load_state_dir(jax_dirs[case])
    got = orbax_store.load_state_dir(jax_dirs[case])
    _trees_equal(got, want)
    mine = str(tmp_path / 'state_latest.orbax')
    orbax_store.save_state_dir(mine, got)
    _trees_equal(jorbax.load_state_dir(mine), want)
    assert _ts_keys(mine) == _ts_keys(jax_dirs[case])
    # the port's slots and count, by the key paths the directory lists
    tree = store.load_state(jax_dirs[case])
    assert (tree['step'], tree['epoch']) == (want['step'], want['epoch'])
    count, slots = store._slots_of(want['opt_state'])
    assert tree['count'] == count and sorted(tree['slots']) == sorted(slots)
    for s, t in slots.items():
        ref = params_from_jax({'params': t})
        assert all(tree['slots'][s][k].numpy().tobytes()
                   == ref[k].numpy().tobytes() for k in ref)


def test_plain_zarr_layout_raises(tmp_path):
    """A directory orbax wrote with use_ocdbt=False (one zarr directory
    per leaf; the JAX package never writes one) is refused by name."""
    import orbax.checkpoint as ocp
    tree = fixture_tree()
    path = str(tmp_path / 'plain.orbax')
    ocp.Checkpointer(ocp.StandardCheckpointHandler(use_ocdbt=False)).save(
        path, {'params': tree['params'], 'batch_stats': {}})
    with pytest.raises(ValueError, match='only OCDBT'):
        orbax_store.load_weights_dir(path)


def test_interrupted_save_keeps_old_snapshot(tmp_path, monkeypatch):
    path = str(tmp_path / 'state_latest.orbax')
    tree = fixture_tree()
    orbax_store.save_weights_dir(path, tree['params'])

    def fail(*a, **k):
        raise OSError('disk full')

    monkeypatch.setattr(ocdbt, 'write_db', fail)
    with pytest.raises(OSError):
        orbax_store.save_weights_dir(path, {'x': np.zeros(3, np.float32)})
    _trees_equal(orbax_store.load_weights_dir(path)['params'],
                 tree['params'])
    assert os.listdir(tmp_path) == ['state_latest.orbax']


def test_fixture_restores_to_seeded_arrays():
    """The committed JAX-written directory (tests/make_orbax_fixture.py)
    restores through the JAX package to its seeded arrays, and the port
    reads the same arrays."""
    want = fixture_tree()
    _trees_equal(jorbax.load_weights_dir(FIXTURE),
                 {**want, 'batch_stats': None})
    _trees_equal(orbax_store.load_weights_dir(FIXTURE),
                 {**want, 'batch_stats': None})
    size = sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(FIXTURE) for f in fs)
    assert size <= 1 << 20
