"""The port's HDF5 codec (`ursonet_torch/checkpoint/hdf5.py`) against
h5py in both directions: files h5py writes read back through the port
with the same arrays and attributes, files the port writes read back
through h5py. Arrays are compared exactly (tolerance 0): the codec moves
bytes, it computes nothing."""

import h5py
import numpy as np
import pytest

from ursonet_torch.checkpoint import hdf5


def _same(got, want):
    """Equal values, and the same kind of value (scalar, str, array)."""
    if isinstance(want, str):
        assert isinstance(got, str) and got == want
    elif isinstance(want, bytes):
        assert isinstance(got, bytes) and got == want
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.shape == want.shape
        assert got.dtype.kind == want.dtype.kind
        if want.dtype.kind == 'f':
            np.testing.assert_array_equal(got, want)
        else:
            assert got.tolist() == want.tolist()
    else:
        assert np.ndim(got) == 0 and got == want and \
            np.asarray(got).dtype == np.asarray(want).dtype.newbyteorder('=')


@pytest.fixture(scope='module')
def h5py_file(tmp_path_factory):
    """A file written by h5py with the features Keras weight files use."""
    path = str(tmp_path_factory.mktemp('h5') / 'by_h5py.h5')
    rng = np.random.RandomState(0)
    with h5py.File(path, 'w') as f:
        f.attrs['layer_names'] = np.array([b'conv1', b'bn_conv1', b'fc'])
        f.attrs['keras_version'] = '2.2.4'           # variable-length str
        f.attrs['backend'] = 'tensorflow'
        f.attrs['vlen_list'] = np.array(['a', 'bcd', ''],
                                        dtype=h5py.string_dtype())
        f.attrs['scalar_f64'] = np.float64(3.5)
        f.attrs['ints_be'] = np.arange(-2, 3, dtype='>i4')
        f.attrs['one_bytes'] = b'conv1/kernel:0'
        for i in range(40):               # a B-tree over several nodes
            g = f.create_group(f'layer{i:03d}')
            g.create_dataset(f'layer{i:03d}/kernel:0',
                             data=rng.randn(3, 3, 2, 4).astype(np.float32))
            g.attrs['weight_names'] = np.array(
                [f'layer{i:03d}/kernel:0'.encode()])
        deep = f.create_group('a/b/c/d')  # nested groups
        deep.create_dataset('leaf', data=rng.randn(5).astype(np.float32))
        f.create_dataset('f64_be', data=rng.randn(7).astype('>f8'))
        f.create_dataset('f16', data=rng.randn(4).astype(np.float16))
        f.create_dataset('i16', data=np.arange(-4, 4, dtype=np.int16))
        f.create_dataset('u8', data=np.arange(250, 256, dtype=np.uint8))
        f.create_dataset('i64_be', data=np.arange(3, dtype='>i8'))
        f.create_dataset('scalar', data=np.float32(2.5))
        f.create_dataset('strings', data=np.array([b'ab', b'cde']))
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_layout(h5py.h5d.COMPACT)
        dsid = h5py.h5d.create(f.id, b'compact', h5py.h5t.IEEE_F32LE,
                               h5py.h5s.create_simple((2, 3)), dcpl=dcpl)
        dsid.write(h5py.h5s.ALL, h5py.h5s.ALL,
                   np.arange(6, dtype=np.float32).reshape(2, 3))
        big = f.create_group('many_attrs')
        for i in range(60):
            big.attrs[f'attr_{i:03d}'] = rng.randn(i + 1).astype(np.float32)
        f.create_dataset('chunked', data=np.zeros((8, 8), np.float32),
                         chunks=(4, 4))
        f.create_dataset('gzip', data=np.zeros((8, 8), np.float32),
                         compression='gzip')
    return path


def _walk(h5obj, prefix=''):
    for k, v in h5obj.items():
        yield prefix + k, v
        if isinstance(v, h5py.Group):
            yield from _walk(v, prefix + k + '/')


def test_reads_what_h5py_writes(h5py_file):
    f = hdf5.File(h5py_file)
    with h5py.File(h5py_file, 'r') as ref:
        # the 60 attributes spill into a continuation block of the
        # object header
        assert h5py.h5o.get_info(ref['many_attrs'].id).hdr.nchunks >= 2
        names = []
        for name, obj in _walk(ref):
            if name in ('chunked', 'gzip'):
                continue
            names.append(name)
            mine = f[name]
            assert set(mine.attrs) == set(obj.attrs), name
            for k in obj.attrs:
                _same(mine.attrs[k], obj.attrs[k])
            if isinstance(obj, h5py.Dataset):
                assert isinstance(mine, hdf5.Dataset)
                assert mine.shape == obj.shape
                if obj.shape == ():
                    _same(mine[()], obj[()])
                else:
                    _same(np.asarray(mine), obj[()])
            else:
                assert isinstance(mine, hdf5.Group)
                assert sorted(mine.keys()) == sorted(obj.keys())
        assert 'a/b/c/d/leaf' in names and 'compact' in names
        assert sorted(f.keys()) == sorted(ref.keys())
        for k in ref.attrs:
            _same(f.attrs[k], ref.attrs[k])


@pytest.mark.parametrize('name,feature', [('chunked', 'chunked'),
                                          ('gzip', 'filter pipeline')])
def test_refuses_chunked_and_filtered_data(h5py_file, name, feature):
    with pytest.raises(ValueError, match=feature) as e:
        hdf5.File(h5py_file)[name]
    assert h5py_file in str(e.value) and f'/{name}' in str(e.value)


def test_refuses_what_it_does_not_read(tmp_path):
    latest = str(tmp_path / 'latest.h5')
    with h5py.File(latest, 'w', libver='latest') as f:
        f.create_dataset('x', data=np.zeros(3, np.float32))
    with pytest.raises(ValueError, match='superblock version'):
        hdf5.File(latest)
    ordered = str(tmp_path / 'ordered.h5')
    with h5py.File(ordered, 'w') as f:
        f.create_group('g', track_order=True).create_dataset(
            'x', data=np.zeros(2, np.float32))
    with pytest.raises(ValueError, match='/g: .*version-2 object header'):
        hdf5.File(ordered)['g']
    junk = tmp_path / 'junk.h5'
    junk.write_bytes(b'not hdf5 at all' * 10)
    with pytest.raises(ValueError, match='not an HDF5 file'):
        hdf5.File(str(junk))


def test_h5py_reads_what_the_port_writes(tmp_path):
    path = str(tmp_path / 'by_port.h5')
    rng = np.random.RandomState(1)
    want = {}
    with hdf5.File(path, 'w') as f:
        for i in range(300):     # two B-tree levels in the root group
            g = f.create_group(f'layer{i:03d}')
            a = rng.randn(3, 3, 4, 2).astype(np.float32)
            want[f'layer{i:03d}/layer{i:03d}/kernel:0'] = a
            g.create_dataset(f'layer{i:03d}/kernel:0', data=a)
            g.attrs['weight_names'] = [f'layer{i:03d}/kernel:0'.encode()]
        f.attrs['layer_names'] = [f'layer{i:03d}'.encode()
                                  for i in range(300)]
        f.attrs['scale'] = np.float64(1.5)
        f.attrs['ids'] = np.arange(4, dtype=np.int32)
        f.attrs['single'] = b'abc'
        f.create_group('empty')
        f.create_dataset('deep/er/f64', data=rng.randn(6))
        want['deep/er/f64'] = None
        f.create_dataset('scalar', data=np.float32(4.25))
    with h5py.File(path, 'r') as h:
        for k, a in want.items():
            if a is not None:
                np.testing.assert_array_equal(h[k][()], a)
                assert h[k].dtype == np.float32
        assert list(h['layer042'].attrs['weight_names']) == \
            [b'layer042/kernel:0']
        assert [n.decode() for n in h.attrs['layer_names']] == \
            [f'layer{i:03d}' for i in range(300)]
        assert h.attrs['scale'] == 1.5 and h.attrs['single'] == b'abc'
        assert h.attrs['ids'].tolist() == [0, 1, 2, 3]
        assert list(h['empty']) == []
        assert h['scalar'][()] == np.float32(4.25)
        assert h['deep/er/f64'].dtype == np.float64
        mine = hdf5.File(path)
        np.testing.assert_array_equal(np.asarray(mine['deep/er/f64']),
                                      h['deep/er/f64'][()])
        for k in ('layer_names', 'scale', 'ids', 'single'):
            _same(mine.attrs[k], h.attrs[k])
    for k, a in want.items():
        if a is not None:
            np.testing.assert_array_equal(np.asarray(mine[k]), a)


def test_writer_refuses_what_it_cannot_write(tmp_path):
    f = hdf5.File(str(tmp_path / 'x.h5'), 'w')
    with pytest.raises(TypeError):
        f.create_dataset('objs', data=np.array(['a'], object))
    with pytest.raises(TypeError):
        f.attrs['s'] = 'text'
        f.close()
    g = hdf5.File(str(tmp_path / 'y.h5'), 'w')
    g.create_dataset('a', data=np.zeros(2, np.float32))
    with pytest.raises(ValueError, match='exists'):
        g.create_dataset('a', data=np.zeros(2, np.float32))
