"""The port's keypoint mode (REGRESS_KEYPOINTS: the 3-keypoint head of
BASELINE.md config 5) and its presets against the JAX package, on the
same inputs made with numpy from a seed, at ResNet-50 depth, 64×64,
BRANCH_SIZE 32, BOTTLENECK_WIDTH 16, batch 2. The weights are the port's
initialization with random batch-norm statistics, converted to the JAX
layout by `checkpoint/convert.py` (no JAX init to compile).

Tolerances:
  * f32 forward: each head within relative L2 1e-4 (as
    tests/test_torch_model.py); losses within 1e-5 relative; one train
    step within 1e-3 in update units, ‖w_port − w_jax‖ / ‖Δw_jax‖ over
    the whole tree, its metrics within 1e-5 (as
    tests/test_torch_train.py);
  * the keypoint decode (batched float64 SVD) equals the JAX package's
    numpy loop to 1e-9, where the reflection fix is taken and where not;
  * the keypoint targets of the device preprocess within 1e-5 (the same
    draws; f32 rotation matrices);
  * the int8 keypoint model under F16 with JAX's calibrated and smoothed
    state carried over: the body (the hidden dense's output that feeds
    the three float finals) bit-exact, the three heads within relative
    L2 1e-2 (bf16 final denses summed in another order, as
    tests/test_torch_f16.py holds `loc`);
  * the presets equal field by field.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import ursonet_tpu.evaluate as jeval
from ursonet_tpu import presets as jpresets
from ursonet_tpu import se3 as jse3
from ursonet_tpu.data import loader as jloader
from ursonet_tpu.data.urso import Camera as JaxCamera
from ursonet_tpu.data.urso import encode_as_keypoints
from ursonet_tpu.models import quant as jq
from ursonet_tpu.models.ursonet import build_model as jax_build_model
from ursonet_tpu.train import losses as jlosses
from ursonet_tpu.train import state as jstate
from ursonet_tpu.train.optim import make_optimizer as jax_make_optimizer
from ursonet_tpu.train.step import make_train_step as jax_make_train_step
from ursonet_torch import evaluate as teval
from ursonet_torch import presets, se3t
from ursonet_torch.checkpoint.convert import params_from_jax, \
    params_to_jax_layout
from ursonet_torch.data import loader as tloader
from ursonet_torch.engine import ServingEngine
from ursonet_torch.models import quant as tq
from ursonet_torch.models.ursonet import build_model
from ursonet_torch.train import losses as tlosses
from ursonet_torch.train.optim import make_optimizer
from ursonet_torch.train.state import trainable_mask
from ursonet_torch.train.step import make_train_step
from test_torch_augment import _jax_rotation_draws, _to_torch
from test_torch_model import _randomize_bn
from test_torch_train import _flat, _rel
from torch_parity import rel_l2, small_configs, unit_quats

torch.set_num_threads(1)

HEADS = ('loc', 'k1', 'k2')
LOC_REL = 1e-2          # a bf16 final dense summed in another order


def port_variables(tcfg, seed=0):
    """The port's initialization for `tcfg` in the JAX layout, with
    random batch-norm statistics and affine parameters."""
    model = build_model(tcfg, 'cpu', torch.Generator().manual_seed(seed))
    return _randomize_bn(params_to_jax_layout(model.state_dict()),
                         np.random.RandomState(seed))


def kp_batch(seed=0, b=2, dim=64):
    """A molded batch with keypoint targets of plausible poses."""
    rng = np.random.RandomState(seed)
    loc = np.stack([rng.uniform(-3, 3, b), rng.uniform(-3, 3, b),
                    rng.uniform(5, 40, b)], 1).astype(np.float32)
    k1, k2 = encode_as_keypoints(unit_quats(rng, b), loc, 3.0)
    return {'images': (rng.randn(b, dim, dim, 3) * 50).astype(np.float32),
            'gt_loc': loc, 'gt_k1': k1, 'gt_k2': k2}


def _torch_batch(batch):
    out = {k: torch.from_numpy(v) for k, v in batch.items()}
    out['images'] = torch.from_numpy(
        batch['images'].transpose(0, 3, 1, 2).copy())
    return out


@pytest.fixture(scope='module')
def kp():
    """The small keypoint configuration in both packages, its JAX model
    and one set of weights."""
    jcfg, tcfg = small_configs(REGRESS_KEYPOINTS=True)
    return jcfg, tcfg, jax_build_model(jcfg), port_variables(tcfg)


def _port_model(tcfg, tree):
    model = build_model(tcfg, device='cpu')
    model.load_state_dict(params_from_jax(tree))
    return model


def test_keypoint_forward_matches_jax(kp):
    jcfg, tcfg, jmodel, tree = kp
    x = kp_batch(1)['images']
    ref = jmodel.apply(tree, jnp.asarray(x), training=True)
    model = _port_model(tcfg, tree)
    assert not hasattr(model, 'ori_head')
    with torch.no_grad():
        got = model(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    assert set(got) == set(ref) == set(HEADS)
    for k in HEADS:
        assert got[k].dtype == torch.float32 and got[k].shape == (2, 3)
        assert rel_l2(got[k].numpy(), ref[k]) <= 1e-4, k


def test_keypoint_losses_match_jax():
    jcfg, tcfg = small_configs(REGRESS_KEYPOINTS=True,
                               LOSS_WEIGHTS={'loc_loss': 0.5, 'k2_loss': 2.0,
                                             'k3_loss': 1.5})
    rng = np.random.RandomState(4)
    batch = kp_batch(4)
    outs = {k: rng.randn(2, 3).astype(np.float32) * 5 for k in HEADS}
    jt, jp = jlosses.compute_losses(
        {k: jnp.asarray(v) for k, v in outs.items()},
        {k: jnp.asarray(v) for k, v in batch.items()}, jcfg)
    tt, tp = tlosses.compute_losses(
        {k: torch.from_numpy(v) for k, v in outs.items()},
        _torch_batch(batch), tcfg)
    assert list(tp) == list(jp) == ['loc_loss', 'k2_loss', 'k3_loss']
    assert _rel(tt, jt) <= 1e-5
    for k in jp:
        assert tp[k].dtype == torch.float32
        assert _rel(tp[k], jp[k]) <= 1e-5, k


def test_keypoint_train_step_matches_jax(kp):
    jcfg, tcfg, jmodel, tree = kp
    batch = kp_batch(2)
    tx = jax_make_optimizer(jcfg)
    state = jstate.state_from_params(tree['params'], tree['batch_stats'], tx)
    jstep = jax_make_train_step(
        jmodel, jcfg, tx, trainable=jstate.trainable_mask(state.params, 'all'))
    state, jm = jstep(state, {k: jnp.asarray(v) for k, v in batch.items()},
                      jax.random.PRNGKey(0))
    model = _port_model(tcfg, tree)
    tm = make_train_step(model, tcfg, make_optimizer(tcfg),
                         trainable=trainable_mask(model, 'all'),
                         device='cpu')(_torch_batch(batch))
    names_j, wj = _flat(jax.tree_util.tree_map(np.asarray, state.params))
    names_t, wt = _flat(params_to_jax_layout(model.state_dict())['params'])
    _, w0 = _flat(tree['params'])
    assert names_j == names_t
    assert np.linalg.norm(wt - wj) / np.linalg.norm(wj - w0) <= 1e-3
    assert set(tm) == set(jm) == {'loc_loss', 'k2_loss', 'k3_loss', 'loss',
                                  'l2_reg'}
    for k in jm:
        assert _rel(tm[k], jm[k]) <= 1e-5, k


def test_keypoint_params_round_trip_and_heads_mask(kp):
    _, tcfg, _, tree = kp
    back = params_to_jax_layout(params_from_jax(tree))
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b)
    assert set(tree['params']['loc_head']) == {
        'loc_dense_0', 'k1_final', 'k2_final', 'k3_final'}
    model = _port_model(tcfg, tree)
    jmask = jstate.trainable_mask(tree['params'], 'heads')
    as_sd = params_from_jax({'params': jax.tree_util.tree_map(
        lambda m, p: np.full(p.shape, m, np.float32), jmask,
        tree['params'])})
    tmask = trainable_mask(model, 'heads')
    assert set(as_sd) == set(tmask)
    for name, flag in tmask.items():
        assert bool(as_sd[name].reshape(-1)[0]) == flag, name
    for i in (1, 2, 3):
        assert tmask[f'loc_head.k{i}_final.weight']
    assert not tmask['backbone.res5c.res5c_branch2c.weight']


def _kp_outputs(rng, n):
    """Keypoint head outputs near a pose: loc, then k1 and k2 at 3 m along
    the rotated z and y axes, with noise."""
    loc = np.stack([rng.uniform(-3, 3, n), rng.uniform(-3, 3, n),
                    rng.uniform(5, 40, n)], 1)
    k1, k2 = encode_as_keypoints(unit_quats(rng, n), loc, 3.0)
    noise = rng.randn(2, n, 3) * rng.uniform(0, 2, (1, n, 1))
    return {'loc': loc.astype(np.float32),
            'k1': (k1 + noise[0]).astype(np.float32),
            'k2': (k2 + noise[1]).astype(np.float32)}


def _reflection_fix_taken(loc, k1, k2, scale):
    """Whether the JAX package's loop multiplies by det(U)·det(V) = -1."""
    P1 = np.zeros((3, 3))
    P1[2, 0] = P1[1, 1] = scale
    P2 = np.stack([k1, k2, loc], axis=1).astype(np.float64)
    H = (P1 - P1.mean(1, keepdims=True)) @ (P2 - P2.mean(1, keepdims=True)).T
    U, _, Vh = np.linalg.svd(H)
    return np.linalg.det(U) * np.linalg.det(Vh.T) < 0


@pytest.mark.parametrize('dataset_name', ['Urso', 'Speed'])
def test_keypoint_decode_matches_jax(dataset_name):
    _, tcfg = small_configs(REGRESS_KEYPOINTS=True)
    jcfg, _ = small_configs(REGRESS_KEYPOINTS=True)
    out = _kp_outputs(np.random.RandomState(3), 64)
    ds = types.SimpleNamespace(name=dataset_name)
    scale = 3.0 if dataset_name == 'Urso' else 1.0
    flips = [_reflection_fix_taken(out['loc'][i], out['k1'][i],
                                   out['k2'][i], scale) for i in range(64)]
    assert any(flips) and not all(flips)
    want_loc, want_q = jeval.decode_results(out, jcfg, ds)
    got_loc, got_q = teval.decode_results(
        {k: torch.from_numpy(v) for k, v in out.items()}, tcfg,
        dataset_name=dataset_name)
    assert got_q.dtype == np.float64 and got_q.shape == (64, 4)
    np.testing.assert_allclose(got_loc, want_loc, rtol=0, atol=1e-9)
    np.testing.assert_allclose(got_q, want_q, rtol=0, atol=1e-9)


@pytest.mark.parametrize('n_points', [3, 5])
def test_kabsch_rotation_matches_jax_pose_3Dto3D(n_points):
    """The batched rotation against the JAX package's numpy
    pose_3Dto3D (centroid branch) on arbitrary point sets, reflections
    among them."""
    rng = np.random.RandomState(n_points)
    P1 = rng.randn(3, n_points)
    P2 = rng.randn(32, 3, n_points) * 4
    got = se3t.kabsch_rotation(torch.from_numpy(P1), torch.from_numpy(P2))
    assert got.shape == (32, 3, 3) and got.dtype == torch.float64
    flips = []
    for i in range(32):
        _, want = jse3.pose_3Dto3D(P1, P2[i])
        np.testing.assert_allclose(got[i].numpy(), want, rtol=0, atol=1e-9)
        H = (P1 - P1.mean(1, keepdims=True)) \
            @ (P2[i] - P2[i].mean(1, keepdims=True)).T
        U, _, Vh = np.linalg.svd(H)
        flips.append(np.linalg.det(U) * np.linalg.det(Vh) < 0)
    assert any(flips) and not all(flips)


@pytest.mark.parametrize('rot,dataset_name', [
    (True, 'Urso'), (True, 'Speed'), (False, 'Urso')])
def test_keypoint_preprocess_matches_jax(rot, dataset_name):
    jcfg, tcfg = small_configs(mode='pad64', dim=128,
                               REGRESS_KEYPOINTS=True, ROT_AUG=rot,
                               ROT_IMAGE_AUG=rot, IMAGES_PER_GPU=6)
    ds = types.SimpleNamespace(camera=JaxCamera(), name=dataset_name,
                               ori_histogram_map=None, ori_output_mask=None)
    rng = np.random.RandomState(2)
    b = jcfg.BATCH_SIZE
    h, w = int(jcfg.IMAGE_SHAPE[0]), int(jcfg.IMAGE_SHAPE[1])
    loc = np.stack([rng.uniform(-3, 3, b), rng.uniform(-3, 3, b),
                    rng.uniform(5, 40, b)], 1).astype(np.float32)
    q = unit_quats(rng, b)
    k1, k2 = encode_as_keypoints(q, loc, 3.0)
    raw = {'images_u8': rng.randint(0, 256, (b, h, w, 3)).astype(np.uint8),
           'location': loc, 'quaternion': q, 'gt_k1': k1, 'gt_k2': k2,
           'image_meta': np.zeros((b, 12), np.float32)}
    key = jax.random.PRNGKey(7)
    ref = jloader.make_device_preprocess(jcfg, ds)(
        key, {k: jnp.asarray(v) for k, v in raw.items()})
    pre = tloader.make_device_preprocess(tcfg, device='cpu',
                                         dataset_name=dataset_name)
    draws = None
    if rot:
        _, sub = jax.random.split(key)
        draws = _to_torch(_jax_rotation_draws(sub, b))
    got = pre(raw, draws)
    assert set(got) == set(ref) == {'images', 'image_meta', 'gt_loc',
                                    'gt_k1', 'gt_k2'}
    assert got['images'].dtype == torch.float32
    for k in ('gt_loc', 'gt_k1', 'gt_k2'):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-5, atol=1e-5)
    if not rot:
        np.testing.assert_array_equal(got['gt_k1'].numpy(), k1)
    else:
        # the targets moved with the pose: k1 - loc is still 3 m (URSO)
        # or 1 m long
        d = np.linalg.norm(got['gt_k1'].numpy() - got['gt_loc'].numpy(),
                           axis=1)
        np.testing.assert_allclose(d, tloader.keypoint_scale(dataset_name),
                                   rtol=1e-5)


def test_int8_keypoint_model_matches_jax_under_f16(kp):
    """JAX's calibrated and smoothed int8 keypoint model (F16: bf16
    epilogues) carried over to the port: the body bit-exact, the three
    float finals within LOC_REL, the plain versions equal to the
    wrappers."""
    _, _, _, tree = kp
    jcfg, tcfg = small_configs(REGRESS_KEYPOINTS=True, F16=True)
    jqm = jq.QuantizedModel.from_variables(jcfg, tree['params'],
                                           tree['batch_stats'])
    rng = np.random.RandomState(5)
    calib = rng.randint(0, 256, (2, 64, 64, 3)).astype(np.uint8)
    x = rng.randint(0, 256, (2, 64, 64, 3)).astype(np.uint8)
    jqm.calibrate(jnp.asarray(calib))
    jqm.smooth(0.5)
    mcfg = jqm._mcfg
    assert mcfg['regress_keypoints']

    def body_of(ops):
        """Record the input of the first float final dense."""
        seen, final = [], ops.dense_final

        def dense_final(h, site):
            seen.append(h)
            return final(h, site)
        ops.dense_final = dense_final
        return seen

    def jfn(q, flat, images):
        ops = jq.Int8Ops(q, flat, jqm.act_scales, jqm.acc_dtype,
                         mean_pixel=mcfg['mean_pixel'])
        seen = body_of(ops)
        out = jq.twin_forward(ops, images, mcfg)
        return out, seen[0]

    flat = jqm._flat_f32()
    ffinal = {s: flat[s] for s in jq.float_sites(mcfg) if s in flat}
    want, want_body = jax.jit(jfn)(jqm._prepared_q(), ffinal, jnp.asarray(x))

    qm = tq.QuantizedModel(tcfg, {k: (np.array(w), np.array(b))
                                  for k, (w, b) in jqm.flat.items()},
                           device='cpu')
    qm.act_scales = dict(jqm.act_scales)
    assert qm._mcfg == mcfg and qm.acc_dtype == torch.bfloat16
    ops = qm._int8_ops()
    seen = body_of(ops)
    with torch.no_grad():
        got = tq.twin_forward(ops, qm._images(x), qm._mcfg)
    body = seen[0]
    np.testing.assert_array_equal(
        body.to(torch.float32).numpy(),
        np.asarray(jnp.asarray(want_body, jnp.float32)))
    assert set(got) == set(want) == set(HEADS)
    plain = qm(x, plain=True)
    for k in HEADS:
        assert got[k].dtype == torch.float32 and got[k].shape == (2, 3)
        assert rel_l2(got[k].numpy(), np.asarray(want[k])) <= LOC_REL, k
        torch.testing.assert_close(plain[k], got[k], rtol=0, atol=0)


def _shared_fields(got, want):
    """The knobs of the port's Config that the JAX package's has too (the
    port leaves out mesh, Pallas, loader and checkpoint knobs)."""
    return {k for k in dir(got) if k.isupper() and hasattr(want, k)}


@pytest.mark.parametrize('which', [('benchmark', 5), ('released', 'speed'),
                                   ('released', 'soyuz_hard'),
                                   ('released', 'dragon_hard')])
def test_presets_match_jax(which):
    kind, arg = which
    make = {'benchmark': (presets.benchmark_config,
                          jpresets.benchmark_config),
            'released': (presets.released_config,
                         jpresets.released_config)}[kind]
    got, want = make[0](arg), make[1](arg)
    fields = _shared_fields(got, want)
    assert {'REMAT', 'F16', 'BACKBONE', 'REGRESS_KEYPOINTS',
            'IMAGE_SHAPE'} <= fields
    for k in sorted(fields):
        a, b = getattr(got, k), getattr(want, k)
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=k)
        else:
            assert a == b, (k, a, b)
    if kind == 'benchmark':
        assert got.REMAT is True and got.REGRESS_KEYPOINTS and got.F16
        assert got.BACKBONE == 'resnet101' and got.BATCH_SIZE == 16
    with pytest.raises(ValueError):
        presets.released_config('no_such_model')


@pytest.mark.parametrize('int8', [False, True])
def test_engine_detects_keypoints(int8):
    """ServingEngine.detect on a keypoint model returns loc, k1 and k2 per
    image, from the float model and from the int8 one."""
    _, tcfg = small_configs(REGRESS_KEYPOINTS=True, F16=True)
    eng = ServingEngine(tcfg, 'cpu',
                        generator=torch.Generator().manual_seed(0))
    images = list(np.random.RandomState(6).randint(
        0, 256, (2, 64, 64, 3)).astype(np.uint8))
    if int8:
        eng.quantize(images)
    res = eng.detect(images)
    assert len(res) == 2
    for r in res:
        assert set(r) == set(HEADS)
        for k in HEADS:
            assert r[k].shape == (3,) and np.isfinite(r[k]).all()
    loc, q = teval.decode_results(
        {k: np.stack([r[k] for r in res]) for k in HEADS}, tcfg)
    np.testing.assert_allclose(np.linalg.norm(q, axis=1), 1, rtol=1e-9)


@pytest.mark.parametrize('n', [3, 5])
def test_chip_smoke_bf16_paths_on_cpu(n):
    """chip_smoke.py's bf16 train phase at a small size on the CPU: the
    F16 flagship recipe (3) and config 5 (5), 3 steps and a validation
    step each, the loss falling; config 5's validation decoded through
    the keypoint SVD, its raw keypoints giving back their poses, and its
    gradients the same under every REMAT policy."""
    cfg = chip_smoke.small_config(n)
    cfg.F16 = True
    cfg.update()
    res = chip_smoke.run_main_path(cfg, 'cpu', seed=0, steps=3)
    chip_smoke.check_main_path(res)
    if n == 5:
        assert cfg.REMAT is True and cfg.BACKBONE == 'resnet101'
        assert set(res['val']) == {'loc_loss', 'k2_loss', 'k3_loss', 'loss'}
        dec = chip_smoke.decode_keypoint_validation(res, cfg, 0)
        assert dec['min_dot'] > 1 - 1e-5
        assert np.isfinite(dec['scores']['mean_esa'])
        # on the CPU every policy gives the no-REMAT gradients exactly
        assert chip_smoke.remat_grad_rel(res, 0, cfg.REMAT) == {
            'False': 0.0, 'True': 0.0, 'narrow': 0.0, 'dots': 0.0}
        assert all(res['model'].backbone._modules[b].remat is True
                   for b in res['model'].backbone.blocks)
    raw = chip_smoke.make_raw_batch(cfg, 1)
    k1, k2 = encode_as_keypoints(raw['quaternion'], raw['location'], 3.0)
    np.testing.assert_allclose(raw['gt_k1'], k1, rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(raw['gt_k2'], k2, rtol=1e-6, atol=1e-5)
