"""The port's evaluation loop (`ursonet_torch/evaluate.py`), its mixture
fit (`ops/gmm.py`) and overlays (`ops/viz.py`) against the JAX
package's, on one synthetic URSO dataset both adapters read. A stub
engine per package returns the same seeded raw heads for the same
sequence of served chunks, so the two loops differ only in their own
code.

Tolerances. Both packages compute the errors in float32 and neither
rounds like the other: XLA's float32 arccos differs from numpy's and
torch's in the last place on about 40% of inputs, and the orientation
decode sums its bins in another order (1e-5 in
tests/test_torch_serving.py). Near a zero angle arccos multiplies such
differences by 1/sin(angle/2) (about 23 at 5 degrees), so orientation
errors, the ESA score and the encoding floors agree within 1e-4
relative, location errors within 1e-6. So the CSVs of the two packages
are the same bytes only for `dists_err.csv` (labels); for every CSV the
port writes the bytes pandas writes for the same array. The float64
host math (the GMM fit, `project_points`, `axes_endpoints`) agrees
within 1e-9 and 1e-12.
"""

import os

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import ursonet_tpu.evaluate as jeval
from ursonet_tpu.data.urso import Urso as JaxUrso
from ursonet_tpu.ops import gmm as jgmm
from ursonet_tpu.ops import viz as jviz
from ursonet_torch import evaluate as teval
from ursonet_torch.data.png import decode_png
from ursonet_torch.data.synthetic import make_urso_dataset
from ursonet_torch.data.urso import Urso
from ursonet_torch.ops import gmm as tgmm
from ursonet_torch.ops import viz as tviz
from torch_parity import small_configs, unit_quats

torch.set_num_threads(1)

LOC_TOL = 1e-6
ORI_TOL = 1e-4
HOST_TOL = 1e-9

HEADS = {
    'classify_ori': dict(REGRESS_LOC=True, REGRESS_ORI=False,
                         ORI_BINS_PER_DIM=6),
    'classify_both': dict(REGRESS_LOC=False, LOC_BINS_PER_DIM=4,
                          REGRESS_ORI=False, ORI_BINS_PER_DIM=4),
    'regress_both': dict(REGRESS_LOC=True, REGRESS_ORI=True,
                         ORIENTATION_PARAM='quaternion'),
}


class StubEngine:
    """`mold_inputs` and `predict_molded` as the loops call them: the k-th
    served chunk gets the heads drawn from RandomState(100 + k)."""

    def __init__(self, config, as_torch: bool):
        self.config = config
        self.as_torch = as_torch
        self.calls = 0

    def mold_inputs(self, images):
        return np.stack([np.asarray(im, np.float32) for im in images]), \
            None, None

    def predict_molded(self, molded):
        cfg = self.config
        rng = np.random.RandomState(100 + self.calls)
        self.calls += 1
        n = len(molded)
        loc = rng.uniform(-2, 2, (n, 3)) + [20.0, 0.0, 0.0] \
            if cfg.REGRESS_LOC else rng.randn(n, cfg.LOC_BINS_PER_DIM ** 3) * 3
        if cfg.REGRESS_ORI:
            ori = rng.randn(n, 4)
        else:
            ori = rng.randn(n, cfg.ORI_BINS_PER_DIM ** 3) * 2
            ori[np.arange(n), rng.randint(0, ori.shape[1], n)] += 8.0
        out = {'loc': loc.astype(np.float32), 'ori': ori.astype(np.float32)}
        if self.as_torch:
            return {k: torch.from_numpy(v) for k, v in out.items()}
        return {k: jnp.asarray(v) for k, v in out.items()}


@pytest.fixture(scope='module')
def urso_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp('eval') / 'urso')
    make_urso_dataset(d, subsets=('test',), n_per_subset=7, width=64,
                      height=48, seed=3)
    return d


def _both(urso_dir, heads, batch=3):
    jcfg, tcfg = small_configs(IMAGES_PER_GPU=batch, **HEADS[heads])
    jds, tds = JaxUrso(), Urso()
    jds.load_dataset(urso_dir, jcfg, 'test')
    tds.load_dataset(urso_dir, tcfg, 'test')
    return (jcfg, jds, StubEngine(jcfg, False)), \
        (tcfg, tds, StubEngine(tcfg, True))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize('heads', sorted(HEADS))
def test_evaluate_matches_jax(urso_dir, tmp_path, heads):
    (jcfg, jds, jeng), (tcfg, tds, teng) = _both(urso_dir, heads)
    jout, tout = str(tmp_path / 'jax'), str(tmp_path / 'port')
    want = jeval.evaluate(jeng, jds, out_dir=jout, log_fn=lambda *a: None,
                          multimodal=not tcfg.REGRESS_ORI)
    lines = []
    got = teval.evaluate(teng, tds, out_dir=tout, log_fn=lines.append,
                         multimodal=not tcfg.REGRESS_ORI)
    assert jeng.calls == teng.calls == 3        # 7 ids in chunks of 3
    assert got.keys() == want.keys()
    for k in want:
        _close(got[k], want[k], LOC_TOL if k == 'mean_loc_err' and
               tcfg.REGRESS_LOC else ORI_TOL)
    assert any(line.startswith('ESA score:') for line in lines)
    for name in ('ori_err.csv', 'loc_err.csv', 'dists_err.csv'):
        with open(os.path.join(jout, name), 'rb') as f:
            jbytes = f.read()
        with open(os.path.join(tout, name), 'rb') as f:
            tbytes = f.read()
        jdf = pd.read_csv(os.path.join(jout, name), index_col=0)
        tdf = pd.read_csv(os.path.join(tout, name), index_col=0)
        assert list(jdf.index) == list(tdf.index) == list(range(7))
        _close(tdf.values, jdf.values, LOC_TOL if name != 'ori_err.csv'
               and tcfg.REGRESS_LOC else ORI_TOL)
        if name == 'dists_err.csv':
            assert tbytes == jbytes
        # the writer: pandas' bytes for the array the port wrote
        arr = tdf.values[:, 0].astype(np.float64 if name == 'dists_err.csv'
                                      else np.float32)
        check = str(tmp_path / f'check_{name}')
        teval.write_csv(check, arr)
        with open(check, 'rb') as f:
            assert f.read() == pd.DataFrame(arr).to_csv().encode()


def test_write_csv_is_pandas_bytes(tmp_path):
    rng = np.random.RandomState(0)
    special = [0.0, -0.0, 1e-5, 1e20, 1.5e-7, 123456789.0, 100.0, np.nan,
               np.inf, -np.inf]
    for dtype in (np.float32, np.float64):
        a = np.concatenate([rng.randn(50) * 10.0 ** rng.randint(-3, 4, 50),
                            special]).astype(dtype)
        path = str(tmp_path / f'{np.dtype(dtype).name}.csv')
        teval.write_csv(path, a)
        with open(path, 'rb') as f:
            assert f.read() == pd.DataFrame(a).to_csv().encode()


def test_detect_dataset_matches_jax(urso_dir, tmp_path):
    (jcfg, jds, jeng), (tcfg, tds, teng) = _both(urso_dir, 'classify_ori',
                                                 batch=4)
    want = jeval.detect_dataset(jeng, jds, 5, log_fn=lambda *a: None,
                                multimodal=True)
    out_dir = str(tmp_path / 'overlays')
    got = teval.detect_dataset(teng, tds, 5, out_dir=out_dir,
                               log_fn=lambda *a: None, multimodal=True)
    assert [r['image_id'] for r in got] == [r['image_id'] for r in want]
    for g, w in zip(got, want):
        for k in ('loc_est', 'q_est', 'loc_err', 'ori_err_deg'):
            _close(g[k], w[k], LOC_TOL if k.startswith('loc') else ORI_TOL)
        assert len(g['modes']) == len(w['modes'])
        for gm, wm in zip(g['modes'], w['modes']):
            assert abs(abs(np.dot(gm['q'], wm['q'])) - 1) < 1e-6
            _close(gm['prior'], wm['prior'], ORI_TOL)
    for r in got:
        path = os.path.join(out_dir, f"overlay_{r['image_id']}.png")
        with open(path, 'rb') as f:
            img = decode_png(f.read())
        assert img.shape == tds.load_image(r['image_id']).shape


def test_evaluate_image_matches_jax(urso_dir):
    (jcfg, jds, jeng), (tcfg, tds, teng) = _both(urso_dir, 'classify_ori')
    want = jeval.evaluate_image(jeng, jds, 4, log_fn=lambda *a: None)
    got = teval.evaluate_image(teng, tds, 4, log_fn=lambda *a: None)
    for k in want:
        _close(got[k], want[k], LOC_TOL if k.startswith('loc') else ORI_TOL)


@pytest.mark.parametrize('heads', ['classify_ori', 'classify_both'])
def test_encoding_errors_match_jax(urso_dir, heads):
    (jcfg, jds, _), (tcfg, tds, _) = _both(urso_dir, heads)
    ids = list(tds.image_ids)
    want = jeval.encoding_errors(jcfg, jds, ids)
    got = teval.encoding_errors(tcfg, tds, ids)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        # the location floor is float64 host math; the orientation one
        # decodes in float32
        _close(g, w, HOST_TOL if g is got[0] else ORI_TOL)
    assert len(got[1]) == len(ids)


def test_gmm_and_multimodal_match_jax(urso_dir):
    (jcfg, jds, jeng), (tcfg, tds, _) = _both(urso_dir, 'classify_ori')
    rng = np.random.RandomState(5)
    q_map = tds.ori_histogram_map
    var = (tcfg.BETA / tcfg.ORI_BINS_PER_DIM) ** 2 / 12
    for trial in range(4):
        logits = rng.randn(len(q_map)) * 2
        for _ in range(trial + 1):       # 1 to 4 peaks
            logits[rng.randint(len(q_map))] += 6.0
        pmf = np.exp(logits - logits.max())
        pmf /= pmf.sum()
        want = jgmm.fit_gmm_to_orientation(q_map, pmf, 5, var)
        got = tgmm.fit_gmm_to_orientation(q_map, pmf, 5, var)
        for g, w in zip(got[:3], want[:3]):
            assert g.shape == w.shape
        for g, w in zip(got[:3], want[:3]):
            _close(np.abs(g) if g.ndim == 2 else g,
                   np.abs(w) if w.ndim == 2 else w, HOST_TOL)
        _close(got[3], want[3], HOST_TOL)
    heads = jeng.predict_molded(np.zeros((3, 1)))
    outputs = {k: np.asarray(v) for k, v in heads.items()}
    want = jeval.multimodal_orientations(outputs, jcfg, jds)
    got = teval.multimodal_orientations(outputs, tcfg, tds)
    for (gm, gv, gp), (wm, wv, wp) in zip(got, want):
        # the PMFs are float32 softmaxes of both packages
        np.testing.assert_allclose(np.abs(gm), np.abs(wm), atol=1e-5)
        _close(gp, wp, ORI_TOL)
    with pytest.raises(ValueError, match='soft-classification'):
        _, rcfg = small_configs(REGRESS_ORI=True)
        teval.multimodal_orientations(outputs, rcfg, tds)


def test_projection_and_axes_match_jax():
    rng = np.random.RandomState(6)
    K = np.array([[640.0, 0, 320], [0, -480.0, 240], [0, 0, 1]])
    pts = rng.uniform(-3, 3, (20, 3)) + [15.0, 0, 0]
    for frame in ('unreal', 'camera'):
        np.testing.assert_allclose(tviz.project_points(K, pts, frame),
                                   jviz.project_points(K, pts, frame),
                                   rtol=1e-12, atol=1e-12)
    for q in unit_quats(rng, 5):
        loc = rng.uniform(-2, 2, 3) + [20.0, 0, 0]
        for got, want in zip(tviz.axes_endpoints(q, loc, 1.5),
                             jviz.axes_endpoints(q, loc, 1.5)):
            np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def test_save_axes_overlay_draws_on_the_frame(tmp_path):
    rng = np.random.RandomState(7)
    image = rng.randint(0, 40, (96, 128, 3)).astype(np.uint8)
    K = np.array([[64.0, 0, 64], [0, -48.0, 48], [0, 0, 1]])
    q = unit_quats(rng, 2)
    loc_gt = np.array([10.0, 0.5, -0.3])
    loc_est = np.array([11.0, -0.4, 0.2])
    path = str(tmp_path / 'overlay.png')
    assert tviz.save_axes_overlay(image, K, loc_gt, q[0], loc_est, q[1],
                                  path=path) == path
    with open(path, 'rb') as f:
        out = decode_png(f.read())
    assert out.shape == image.shape and out.dtype == np.uint8
    changed = np.any(out != image, axis=-1)
    assert 50 < changed.sum() < out.shape[0] * out.shape[1] // 2
    colours = {tuple(c) for c in out[changed]}
    for c in tviz.AXIS_COLORS + (tviz.LIME, tviz.YELLOW):
        assert c in colours, c
    # a frame without the estimate: the ground-truth axes only
    alone = tviz.draw_axes_overlay(image, K, loc_gt, q[0])
    assert not {tviz.LIME, tviz.YELLOW} & {
        tuple(c) for c in alone.reshape(-1, 3)}
