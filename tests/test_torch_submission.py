"""The port's ESA submission (`ursonet_torch/submission.py`, the CLI's
`submit`) against the JAX package's (`ursonet_tpu/submission.py`,
`pose_estimator.py submit`).

Tolerances: the writer's CSV bytes equal on the same decoded poses; the
command line's `submit` on a tiny synthetic SPEED set with the same
weights: the same file names in the same order (test, then real_test,
each sorted), scalar-first quaternions within 1e-5 and locations within
1e-5 relative (the two forwards and decodes are float32 in another
order; the random weights put the locations at tens of metres, where
the measured difference is 4.4e-6 relative, 1.9e-4 m)."""

import csv
import glob
import os
import shutil

import numpy as np
import pytest
import torch

import pose_estimator as jcli
from ursonet_tpu.submission import SubmissionWriter as JaxWriter
from ursonet_torch import pose_estimator as tcli
from ursonet_torch.data.synthetic import make_speed_dataset
from ursonet_torch.engine import UrsoNet
from ursonet_torch.submission import SubmissionWriter

torch.set_num_threads(2)

SUBMIT_TOL = 1e-5
COUNTS = {'train_no_val': 4, 'val': 2, 'test': 3, 'real_test': 2}


def test_writer_bytes_match_jax(tmp_path):
    rng = np.random.RandomState(0)
    writers = (JaxWriter(), SubmissionWriter())
    for i in rng.permutation(7):
        q = list(rng.randn(4))
        r = list(rng.randn(3) * 10)
        for w in writers:
            (w.append_real_test if i % 3 == 0 else w.append_test)(
                f'img{i:06d}.jpg', q, r)
    paths = [w.export(str(tmp_path), suffix=f's{k}')
             for k, w in enumerate(writers)]
    with open(paths[0], 'rb') as a, open(paths[1], 'rb') as b:
        want = a.read()
        assert b.read() == want
    rows = want.decode().splitlines()
    names = [r.split(',')[0] for r in rows]
    test = [n for n in names if int(n[3:9]) % 3]
    real = [n for n in names if int(n[3:9]) % 3 == 0]
    assert names == sorted(test) + sorted(real)


@pytest.fixture(scope='module')
def env(tmp_path_factory):
    root = tmp_path_factory.mktemp('submit')
    make_speed_dataset(str(root / 'datasets' / 'speed'), n_per_subset=COUNTS,
                       width=96, height=60, seed=2)
    out = {'data': str(root / 'datasets'), 'logs': str(root / 'logs'),
           'root': root}
    # seeded random weights of the CLI's configuration, in the JAX layout
    args = tcli.build_parser().parse_args(_argv(out, str(root / 'out')))
    eng = UrsoNet('inference', tcli.make_config(args), out['logs'],
                  device='cpu')
    eng.initialize(seed=3)
    # Seeded random weights give almost flat orientation PMFs, whose
    # decoded quaternion (the dominant eigenvector of the PMF-weighted
    # outer products) is ill-conditioned in both packages: it moved by
    # 1.2e-5 under another thread count. A trained model's PMFs peak:
    # scaling the final orientation layer makes these peak too.
    with torch.no_grad():
        eng.model.ori_head.ori_final.weight.mul_(20.0)
    out['weights'] = str(root / 'weights.msgpack')
    eng.save_weights(out['weights'])
    yield out
    shutil.rmtree(root, ignore_errors=True)


def _argv(env, out, *extra, weights=None):
    os.makedirs(out, exist_ok=True)   # submit writes into an existing dir
    return ['submit', '--dataset', 'speed', '--data_dir', env['data'],
            '--logs', env['logs'], '--out_dir', str(out),
            '--weights', weights or 'none', '--backbone', 'resnet50',
            '--bottleneck', '8', '--branch_size', '16', '--image_scale',
            '0.1', '--ori_resolution', '6', '--eval_batch', '2'] + list(extra)


def _rows(out_dir):
    (path,) = glob.glob(os.path.join(out_dir, 'submission_*.csv'))
    with open(path, newline='') as f:
        return list(csv.reader(f))


def test_cli_submit_matches_jax(env, monkeypatch):
    import jax
    monkeypatch.setattr(jax, 'devices', lambda *a: jax.local_devices()[:1])
    jout, tout = env['root'] / 'jax_out', env['root'] / 'port_out'
    assert jcli.main(_argv(env, jout, weights=env['weights'])) == 0
    assert tcli.main(_argv(env, tout, weights=env['weights']),
                     device='cpu') == 0
    want, got = _rows(jout), _rows(tout)
    assert [r[0] for r in got] == [r[0] for r in want]
    assert len(got) == COUNTS['test'] + COUNTS['real_test']
    g = np.array([r[1:] for r in got], np.float64)
    w = np.array([r[1:] for r in want], np.float64)
    np.testing.assert_allclose(g[:, :4], w[:, :4], rtol=0, atol=SUBMIT_TOL)
    np.testing.assert_allclose(g[:, 4:], w[:, 4:], rtol=SUBMIT_TOL, atol=0)
    # scalar first, on the north hemisphere of the scalar
    np.testing.assert_allclose(np.linalg.norm(g[:, :4], axis=1), 1.0,
                               atol=1e-6)
    assert (g[:, 0] >= 0).all()


def test_cli_submit_int8_writes_every_frame(env):
    out = env['root'] / 'int8_out'
    assert tcli.main(_argv(env, out, '--int8', weights=env['weights']),
                     device='cpu') == 0
    rows = _rows(out)
    assert len(rows) == COUNTS['test'] + COUNTS['real_test']
    assert np.isfinite(np.array([r[1:] for r in rows], np.float64)).all()
