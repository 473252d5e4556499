"""The port's serving tail against the JAX package's on the same inputs
(numpy seeds): the SE(3) decode math (`se3t` vs `se3jax`), the pose
decode (`ops/decode.py`), the ESA score and `evaluate.decode_results`,
and the serving engine's `predict_molded` / `detect` against the JAX
engine's.

Tolerances: 1e-5 for the f32 decode math (sums over 13,824 bins in
another order); quaternions compared up to sign where the solver picks
it (eigh); the engine's int8 outputs at relative L2 1e-3 (the int8
parity bound of test_torch_quant.py).
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ursonet_tpu import engine as jengine
import ursonet_tpu.evaluate as jeval
from ursonet_tpu import se3jax
from ursonet_tpu.models import quant as jq
from ursonet_tpu.models.ursonet import build_model as jax_build_model
from ursonet_tpu.ops import decode as jdecode
from ursonet_torch import evaluate as teval
from ursonet_torch import se3t
from ursonet_torch.engine import ServingEngine
from ursonet_torch.models import quant as tq
from ursonet_torch.ops import decode as tdecode
from ursonet_torch.ops.encoders import build_ori_grid
from test_torch_model import jax_variables
from torch_parity import rel_l2, small_configs, unit_quats

torch.set_num_threads(1)

TOL = 1e-5


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=tol,
                               atol=tol)


def _same_rotation(got, want, tol=TOL):
    got, want = _np(got), np.asarray(want)
    sign = np.sign(np.sum(got * want, axis=-1, keepdims=True))
    np.testing.assert_allclose(got * sign, want, rtol=tol, atol=tol)


def _pmfs(rng, n, bins, peak=8.0):
    """Peaked random logits over bins³ (as a trained head gives)."""
    logits = rng.randn(n, bins ** 3).astype(np.float32)
    logits[np.arange(n), rng.randint(0, bins ** 3, n)] += peak
    return logits


# --------------------------------------------------------------------------
# se3t


def test_quat_inv_euler_angle_match_se3jax():
    rng = np.random.RandomState(0)
    q = unit_quats(rng, 64)
    # the poles: x*z + y*w = ±0.5 exactly and just inside
    q[:4] = np.array([[0.5, 0.5, 0.5, 0.5], [0.5, -0.5, -0.5, 0.5],
                      [0.0, 0.7071068, 0.0, 0.7071068],
                      [0.1, -0.69, 0.1, 0.71]], np.float32)
    q[:4] /= np.linalg.norm(q[:4], axis=1, keepdims=True)
    tq_ = torch.from_numpy(q)
    _close(se3t.quat_inv(tq_), se3jax.quat_inv(jnp.asarray(q)))
    # degrees: 1e-5 of the ±180 range
    _close(se3t.quat2euler(tq_), se3jax.quat2euler(jnp.asarray(q)),
           tol=2e-4)
    q2 = unit_quats(rng, 64)
    _close(se3t.angle_between_quats(tq_, torch.from_numpy(q2)),
           se3jax.angle_between_quats(jnp.asarray(q), jnp.asarray(q2)),
           tol=1e-3)


@pytest.mark.parametrize('bins', [6, 24])
def test_quat_weighted_avg_matches_se3jax(bins):
    rng = np.random.RandomState(1)
    Q = build_ori_grid(bins).quat
    W = np.asarray(jdecode.stable_softmax(jnp.asarray(_pmfs(rng, 5, bins))))
    got_q, got_a = se3t.quat_weighted_avg(torch.from_numpy(Q),
                                          torch.from_numpy(W))
    want_q, want_a = se3jax.quat_weighted_avg(
        jnp.broadcast_to(jnp.asarray(Q), (5,) + Q.shape), jnp.asarray(W))
    _close(got_a, want_a)
    _same_rotation(got_q, want_q)
    got_p = se3t.quat_weighted_avg_power(torch.from_numpy(Q),
                                         torch.from_numpy(W), iters=50)
    want_p = se3jax.quat_weighted_avg_power(
        jnp.broadcast_to(jnp.asarray(Q), (5,) + Q.shape), jnp.asarray(W),
        iters=50)
    _close(got_p, want_p)
    # the batched (..., n, 4) form gives the same
    got_b = se3t.quat_weighted_avg_power(
        torch.from_numpy(np.broadcast_to(Q, (5,) + Q.shape).copy()),
        torch.from_numpy(W), iters=50)
    _close(got_b, got_p)


# --------------------------------------------------------------------------
# decode


def test_classification_decode_matches_jax():
    rng = np.random.RandomState(2)
    bins = 24
    Q = build_ori_grid(bins).quat
    logits = _pmfs(rng, 8, bins)
    _close(tdecode.stable_softmax(torch.from_numpy(logits)),
           jdecode.stable_softmax(jnp.asarray(logits)), tol=1e-6)
    _close(tdecode.decode_ori_pmf(logits, Q),
           jdecode.decode_ori_pmf(jnp.asarray(logits), Q))
    _same_rotation(tdecode.decode_ori_pmf(logits, Q, use_eigh=True),
                   jdecode.decode_ori_pmf(jnp.asarray(logits), Q,
                                          use_eigh=True))
    hmap = rng.uniform(-3, 30, (4 ** 3, 3)).astype(np.float32)
    loc_logits = _pmfs(rng, 8, 4)
    _close(tdecode.decode_loc_pmf(loc_logits, hmap),
           jdecode.decode_loc_pmf(jnp.asarray(loc_logits), hmap))
    pmf = np.asarray(jdecode.stable_softmax(jnp.asarray(loc_logits)))
    _close(tdecode.decode_loc_encoded(pmf, hmap),
           jdecode.decode_loc_encoded(pmf, hmap))


@pytest.mark.parametrize('param', ['quaternion', 'euler_angles',
                                   'angle_axis'])
def test_regression_decode_matches_jax(param):
    rng = np.random.RandomState(3)
    out = rng.randn(16, 4 if param == 'quaternion' else 3) \
        .astype(np.float32) * (60.0 if param == 'euler_angles' else 1.0)
    out[0] = 0.0 if param == 'angle_axis' else out[0]
    _close(tdecode.decode_ori_regression(out, param),
           jdecode.decode_ori_regression(jnp.asarray(out), param))
    with pytest.raises(ValueError):
        tdecode.decode_ori_regression(out, 'bogus')


def test_errors_and_esa_match_jax():
    rng = np.random.RandomState(4)
    q_est, q_gt = unit_quats(rng, 32), unit_quats(rng, 32)
    loc_gt = rng.uniform(5, 40, (32, 3)).astype(np.float32)
    loc_est = loc_gt + rng.randn(32, 3).astype(np.float32)
    _close(tdecode.angular_error_deg(q_est, q_gt),
           jdecode.angular_error_deg(q_est, q_gt), tol=1e-3)
    _close(tdecode.location_error(loc_est, loc_gt),
           jdecode.location_error(loc_est, loc_gt))
    _close(tdecode.esa_score(loc_est, loc_gt, q_est, q_gt),
           jdecode.esa_score(loc_est, loc_gt, q_est, q_gt))
    s = teval.esa_scores(loc_est, q_est, loc_gt, q_gt)
    _close(s['esa'], jdecode.esa_score(loc_est, loc_gt, q_est, q_gt))
    assert s['mean_esa'] == pytest.approx(float(np.mean(s['esa'])))
    assert set(s) == {'esa', 'loc_err', 'ori_err_deg', 'mean_esa',
                      'mean_loc_err', 'mean_ori_err_deg'}


@pytest.mark.parametrize('heads', [
    dict(REGRESS_LOC=True, REGRESS_ORI=False, ORI_BINS_PER_DIM=6),
    dict(REGRESS_LOC=False, LOC_BINS_PER_DIM=4, REGRESS_ORI=True,
         ORIENTATION_PARAM='quaternion'),
    dict(REGRESS_LOC=True, REGRESS_ORI=True,
         ORIENTATION_PARAM='euler_angles')])
def test_decode_results_matches_jax(heads):
    jcfg, tcfg = small_configs(**heads)
    rng = np.random.RandomState(5)
    n = 6
    loc = (rng.randn(n, 3) if tcfg.REGRESS_LOC
           else _pmfs(rng, n, tcfg.LOC_BINS_PER_DIM)).astype(np.float32)
    ori = (_pmfs(rng, n, tcfg.ORI_BINS_PER_DIM) if not tcfg.REGRESS_ORI
           else rng.randn(n, 4 if tcfg.ORIENTATION_PARAM == 'quaternion'
                          else 3) * 40).astype(np.float32)
    hmap = rng.uniform(-3, 30, (tcfg.LOC_BINS_PER_DIM ** 3, 3)) \
        .astype(np.float32)
    ds = SimpleNamespace(histogram_3D_map=hmap,
                         ori_histogram_map=build_ori_grid(
                             tcfg.ORI_BINS_PER_DIM).quat)
    want_loc, want_q = jeval.decode_results({'loc': loc, 'ori': ori}, jcfg,
                                            ds)
    got_loc, got_q = teval.decode_results(
        {'loc': torch.from_numpy(loc), 'ori': torch.from_numpy(ori)}, tcfg,
        histogram_3d_map=hmap)
    assert got_loc.dtype == np.float64 and got_q.dtype == np.float64
    _close(got_loc, want_loc)
    _close(got_q, want_q)


def test_decode_results_refuses_what_it_cannot_decode():
    _, tcfg = small_configs(REGRESS_LOC=False, LOC_BINS_PER_DIM=4)
    out = {'loc': torch.zeros(1, 64), 'ori': torch.zeros(1, 216)}
    with pytest.raises(ValueError):
        teval.decode_results(out, tcfg)
    # keypoint heads decode (tests/test_torch_keypoints.py), from their
    # keypoint outputs only
    _, tcfg = small_configs(REGRESS_KEYPOINTS=True)
    with pytest.raises(KeyError):
        teval.decode_results(out, tcfg)


# --------------------------------------------------------------------------
# the serving engine


@pytest.fixture(scope='module')
def serving_pair():
    """The same calibrated int8 model in the JAX package and the port
    (JAX's calibration carried over), and a port engine serving it."""
    jcfg, tcfg = small_configs()
    tree = jax_variables(jax_build_model(jcfg), (2, 64, 64, 3), seed=7)
    jqm = jq.QuantizedModel.from_variables(jcfg, tree['params'],
                                           tree['batch_stats'])
    calib = np.random.RandomState(8).randint(0, 256, (2, 64, 64, 3)) \
        .astype(np.uint8)
    jqm.calibrate(jnp.asarray(calib))
    eng = ServingEngine(tcfg, device='cpu')
    eng.qmodel = tq.QuantizedModel(tcfg, jqm.flat, device='cpu')
    eng.qmodel.act_scales = dict(jqm.act_scales)
    return jcfg, tcfg, jqm, eng


def _jax_predict_molded(jcfg, jqm, molded):
    """The JAX engine's predict_molded on a one-device host."""
    fake = SimpleNamespace(state=object(), config=jcfg, _qmodel=jqm,
                           mesh=SimpleNamespace(size=1),
                           _host_s2d_maybe=lambda m: m)
    return {k: np.asarray(v) for k, v in
            jengine.UrsoNet.predict_molded(fake, molded).items()}


def test_predict_molded_u8_path_matches_jax_engine(serving_pair):
    """A molded float batch ships as rint(molded + mean) uint8 in both
    engines, then serves int8."""
    jcfg, tcfg, jqm, eng = serving_pair
    rng = np.random.RandomState(9)
    molded = (rng.uniform(0, 255, (2, 64, 64, 3))
              - np.asarray(tcfg.MEAN_PIXEL)).astype(np.float32)
    want = _jax_predict_molded(jcfg, jqm, molded)
    got = eng.predict_molded(molded)
    for k in want:
        assert rel_l2(got[k].numpy(), want[k]) <= 1e-3, k
    # the u8 step itself: the same as serving the rounded pixels
    u8 = np.clip(np.rint(molded + np.asarray(tcfg.MEAN_PIXEL, np.float32)),
                 0, 255).astype(np.uint8)
    direct = eng.predict_molded(u8)
    for k in got:
        torch.testing.assert_close(got[k], direct[k], rtol=0, atol=0)


def test_detect_matches_predict_molded(serving_pair):
    jcfg, tcfg, jqm, eng = serving_pair
    rng = np.random.RandomState(10)
    imgs = [rng.randint(0, 256, (64, 64, 3)).astype(np.uint8)
            for _ in range(tcfg.BATCH_SIZE)]
    res = eng.detect(imgs)
    want = _jax_predict_molded(jcfg, jqm, np.stack(imgs).astype(np.float32)
                               - np.asarray(tcfg.MEAN_PIXEL, np.float32))
    for i, r in enumerate(res):
        for k in ('loc', 'ori'):
            assert rel_l2(r[k], want[k][i]) <= 1e-3, (i, k)
    molded, metas, windows = eng.mold_inputs(imgs)
    assert molded.dtype == np.float32 and metas.shape == (2, 12)
    assert windows.tolist() == [[0, 0, 64, 64]] * 2
    with pytest.raises(ValueError):
        eng.detect(imgs[:1])
    with pytest.raises(NotImplementedError):
        eng.detect([np.zeros((32, 32, 3), np.uint8)] * 2)   # needs a resize


def test_detect_pads_pad64_images(serving_pair):
    """pad64 centers a smaller image in the padded frame, as the JAX
    package's resize_image does at scale 1."""
    from ursonet_tpu.ops import image as jimage
    _, tcfg = small_configs(mode='pad64', dim=192, IMAGE_MIN_DIM=128)
    eng = ServingEngine(tcfg, device='cpu')
    img = np.random.RandomState(11).randint(0, 256, (128, 180, 3)) \
        .astype(np.uint8)
    molded, metas, windows = eng.mold_inputs([img])
    want, window, scale, _, _ = jimage.resize_image(
        img, min_dim=128, max_dim=192, mode='pad64')
    assert scale == 1 and tuple(windows[0]) == tuple(window)
    np.testing.assert_array_equal(
        molded[0], jimage.mold_image(want.astype(np.float32), tcfg))
    np.testing.assert_array_equal(metas[0], jimage.compose_image_meta(
        0, img.shape, want.shape, window, scale))


def test_predict_molded_float_path_is_the_model():
    _, tcfg = small_configs()
    eng = ServingEngine(tcfg, device='cpu',
                        generator=torch.Generator().manual_seed(1))
    x = np.random.RandomState(12).randn(2, 64, 64, 3).astype(np.float32) * 50
    got = eng.predict_molded(x)
    with torch.no_grad():
        want = eng.model(torch.from_numpy(x).permute(0, 3, 1, 2))
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=1e-6, atol=1e-6)
    assert not eng.model.training


def test_quantize_then_serve_calibrates_on_the_molded_images():
    _, tcfg = small_configs()
    eng = ServingEngine(tcfg, device='cpu',
                        generator=torch.Generator().manual_seed(2))
    imgs = [np.random.RandomState(i).randint(0, 256, (64, 64, 3))
            .astype(np.uint8) for i in range(2)]
    qm = eng.quantize(imgs)
    molded, _, _ = eng.mold_inputs(imgs)
    ref = tq.QuantizedModel(tcfg, qm.flat, device='cpu')
    ref.calibrate(np.stack(imgs))      # uint8: mold folded into the twin
    assert qm.act_scales == pytest.approx(ref.act_scales, rel=1e-6)
    out = eng.predict_molded(molded)
    flt = qm.float_twin(molded)
    for k in out:
        assert rel_l2(out[k].numpy(), flt[k].numpy()) < tq.RANDOM_INIT_GATE_REL
    # lazily calibrated on the first served batch when not given images
    eng2 = ServingEngine(tcfg, device='cpu', model=eng.model)
    eng2.quantize()
    assert eng2.qmodel.act_scales is None
    eng2.predict_molded(np.stack(imgs))
    assert eng2.qmodel.act_scales is not None
