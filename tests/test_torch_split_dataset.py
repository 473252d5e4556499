"""The port's dataset splitters (`python -m ursonet_torch.split_dataset`,
no pandas, no PIL) against the repository's `split_dataset.py`: the same
files, byte for byte, from the same seed; the mean pixel exactly."""

import json
import os
import shutil

import numpy as np
import pytest

import split_dataset as jsplit
from ursonet_torch import split_dataset as tsplit
from ursonet_torch.data.png import write_png


def _urso_dir(root, n, rng):
    os.makedirs(root)
    for i in range(n):
        write_png(os.path.join(root, f'{i}_rgb.png'),
                  rng.randint(0, 256, (6, 8, 3)).astype(np.uint8))
    q = rng.randn(n, 4)
    with open(os.path.join(root, 'gt.csv'), 'w') as f:
        f.write('x,y,z,q1,q2,q3,q4,frame,tag\n')
        for i in range(n):
            vals = [rng.uniform(5, 40), rng.randn(), rng.randn() * 1e-5,
                    *q[i]]
            if i == 3:
                vals[1] = 2.0          # an integral value in a float column
            cells = [repr(float(v)) for v in vals] + [str(i * 7),
                                                      f'a,"b{i}'] \
                if i != 5 else [repr(float(v)) for v in vals[:-1]] + \
                ['', str(i * 7), 'plain']
            f.write(','.join(c if ',' not in c else
                             '"' + c.replace('"', '""') + '"'
                             for c in cells) + '\n')
    return root


def _same_files(a, b):
    names = sorted(n for n in os.listdir(a)
                   if os.path.isfile(os.path.join(a, n)))
    assert names == sorted(n for n in os.listdir(b)
                           if os.path.isfile(os.path.join(b, n)))
    for n in names:
        with open(os.path.join(a, n), 'rb') as fa, \
                open(os.path.join(b, n), 'rb') as fb:
            assert fa.read() == fb.read(), n


@pytest.mark.parametrize('n,test_pct,val_pct,seed', [
    (20, 10, 10, 0), (37, 15, 5, 3), (9, 30, 30, 11)])
def test_split_urso_writes_the_same_files(tmp_path, n, test_pct, val_pct,
                                          seed):
    src = _urso_dir(str(tmp_path / 'src'), n, np.random.RandomState(seed))
    a, b = str(tmp_path / 'jax'), str(tmp_path / 'port')
    shutil.copytree(src, a)
    shutil.copytree(src, b)
    want = jsplit.split_urso(a, test_pct, val_pct, seed)
    got = tsplit.split_urso(b, test_pct, val_pct, seed)
    assert got == want and sum(got.values()) == n
    _same_files(a, b)


def test_split_urso_refuses_a_count_mismatch(tmp_path):
    d = _urso_dir(str(tmp_path / 'd'), 5, np.random.RandomState(0))
    os.remove(os.path.join(d, '0_rgb.png'))
    with pytest.raises(ValueError, match='4 images vs 5 poses'):
        tsplit.split_urso(d, seed=0)


@pytest.mark.parametrize('n,val_pct,seed', [(50, 0.1, 0), (13, 0.25, 4)])
def test_split_and_merge_speed_write_the_same_files(tmp_path, n, val_pct,
                                                    seed):
    from ursonet_torch.data.synthetic import make_speed_dataset
    src = str(tmp_path / 'src')
    make_speed_dataset(src, subsets=('train_no_val',), n_per_subset=n,
                       width=16, height=10, seed=seed)
    shutil.move(os.path.join(src, 'train_no_val.json'),
                os.path.join(src, 'train.json'))
    a, b = str(tmp_path / 'jax'), str(tmp_path / 'port')
    shutil.copytree(src, a)
    shutil.copytree(src, b)
    assert tsplit.split_speed(b, val_pct, seed) == \
        jsplit.split_speed(a, val_pct, seed)
    for d, mod in ((a, jsplit), (b, tsplit)):
        assert mod.merge_speed(os.path.join(d, 'val.json'),
                               os.path.join(d, 'train_no_val.json'),
                               os.path.join(d, 'merged.json')) == n
    _same_files(os.path.join(a), os.path.join(b))
    with open(os.path.join(b, 'val.json')) as f:
        assert len(json.load(f)) == int(np.ceil(n * val_pct))


def test_main_and_average_images_match(tmp_path):
    src = _urso_dir(str(tmp_path / 'src'), 12, np.random.RandomState(2))
    a, b = str(tmp_path / 'jax'), str(tmp_path / 'port')
    shutil.copytree(src, a)
    shutil.copytree(src, b)
    jsplit.main(['--dataset_dir', a, '--seed', '5'])
    tsplit.main(['--dataset_dir', b, '--seed', '5'])
    _same_files(a, b)
    np.testing.assert_array_equal(tsplit.average_images(b),
                                  jsplit.average_images(a))


def test_the_float_reader_is_pandas():
    """pandas' default reader is not always the nearest double (about a
    quarter of these differ from float()); the split files carry its
    digits, so the port reads as it does."""
    import io

    import pandas as pd
    rng = np.random.RandomState(0)
    vals = np.concatenate([rng.randn(3000) * 10.0 ** rng.randint(-12, 12,
                                                                   3000),
                           rng.rand(1000) * 100])
    texts = [repr(float(v)) for v in vals] + [
        '1e-320', '123456789012345678901.5', '-0.0', '.5', '5.', '1E5',
        '0.1e-3', '-7']
    want = pd.read_csv(io.StringIO('a\n' + '\n'.join(texts) + '\n'))['a']
    got = np.array([tsplit._pandas_float(t) for t in texts])
    np.testing.assert_array_equal(got.view(np.int64),
                                  want.to_numpy(np.float64).view(np.int64))
    assert (got != np.array([float(t) for t in texts])).sum() > 500
