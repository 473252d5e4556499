"""The port's training engine (`ursonet_torch/engine.py::UrsoNet`) and
its checkpoint store, at the small size (tests/torch_parity.py::
small_configs: ResNet-50 at 64×64, narrow heads, batch 2) on a synthetic
URSO dir of 8 frames a subset at 96×72, against the JAX package where it
has a counterpart (tests/test_engine.py, `checkpoint/store.py`). The two
engines side by side are in tests/test_torch_engine_parity.py, the
Kendall log-variances in tests/test_torch_loss_weights.py.

Tolerances:
  * snapshots and resume within the port exact; a resumed run draws
    and trains as an uninterrupted one, exactly;
  * merge_params: the JAX package's merged trees exactly;
  * the resident train step equals the streaming step fed the same
    batch and draws exactly (the same operations on the CPU).
"""

import glob
import json
import os

import numpy as np
import pytest
import torch

from ursonet_tpu.checkpoint import store as jstore
from ursonet_tpu.ops import image as jimage
from ursonet_torch.checkpoint import store
from ursonet_torch.checkpoint.convert import params_to_jax_layout
from ursonet_torch.data import loader as tloader
from ursonet_torch.data.synthetic import make_urso_dataset
from ursonet_torch.data.urso import Urso
from ursonet_torch.engine import UrsoNet
from ursonet_torch.models.ursonet import build_model
from ursonet_torch.train.optim import make_optimizer
from ursonet_torch.train.step import make_eval_step, \
    make_resident_eval_step, make_resident_train_step, make_train_step
# run_dir is a fixture
from torch_parity import run_dir, small_configs  # noqa: F401

torch.set_num_threads(1)

EPOCHS = 2
ENGINE_KW = dict(STEPS_PER_EPOCH=3, VALIDATION_STEPS=1)


@pytest.fixture(scope='module')
def urso_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp('urso'))
    make_urso_dataset(d, n_per_subset=8, width=96, height=72)
    return d


def _load(cls, d, cfg, subset):
    ds = cls()
    ds.load_dataset(d, cfg, subset)
    return ds


def _trees_equal(a, b, path=''):
    assert isinstance(a, dict) == isinstance(b, dict), path
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            _trees_equal(a[k], b[k], f'{path}/{k}')
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=path)


# --------------------------------------------------------------------------
# the port's engine alone


def test_train_checkpoint_resume_detect(urso_dir, run_dir):
    """The counterpart of tests/test_engine.py's engine test: two epochs
    on the resident path with the rotation augmentation, snapshots,
    metrics, config dump, find_last, load_weights, exact resume, and
    detect on raw 96×72 frames (resampled to 64×64)."""
    _, cfg = small_configs(**ENGINE_KW)
    model_dir = str(run_dir / 'logs')
    train_ds = _load(Urso, urso_dir, cfg, 'train')
    val_ds = _load(Urso, urso_dir, cfg, 'val')
    logs = []
    engine = UrsoNet('training', cfg, model_dir, device='cpu')
    engine.initialize()
    engine.quantize()     # training must drop this stale serving model
    means = engine.train(train_ds, val_ds, cfg.LEARNING_RATE, epochs=EPOCHS,
                         log_fn=logs.append)
    assert engine.serving.qmodel is None
    assert logs[0] == 'data: device-resident (8 train + 8 val images)'
    assert np.isfinite(means['loss']) and np.isfinite(means['val_loss'])
    assert engine.step == EPOCHS * cfg.STEPS_PER_EPOCH

    snaps = sorted(glob.glob(os.path.join(engine.log_dir, 'weights_*')))
    assert len(snaps) == EPOCHS
    with open(os.path.join(engine.log_dir, 'metrics.jsonl')) as f:
        records = [json.loads(line) for line in f]
    assert [r['epoch'] for r in records] == [0, 1]
    assert all(r['imgs_per_s'] > 0 for r in records)
    assert os.path.exists(os.path.join(engine.log_dir, 'config_0.json'))
    assert os.path.exists(os.path.join(engine.log_dir,
                                       'state_latest.msgpack'))

    engine2 = UrsoNet('training', cfg, model_dir, device='cpu')
    last = engine2.find_last()
    assert last == snaps[-1]
    assert engine2.get_last_checkpoint(cfg.NAME) == last
    engine2.load_weights(last)
    assert engine2.epoch == EPOCHS and engine2.log_dir == engine.log_dir
    for k, v in engine.model.state_dict().items():
        torch.testing.assert_close(engine2.model.state_dict()[k], v, rtol=0,
                                   atol=0)

    engine3 = UrsoNet('training', cfg, model_dir, device='cpu')
    assert engine3.resume_state(engine.log_dir)
    assert (engine3.step, engine3.epoch) == (engine.step, EPOCHS)
    assert engine3.velocity.keys() == engine.velocity.keys()
    for k, v in engine.velocity.items():
        torch.testing.assert_close(engine3.velocity[k], v, rtol=0, atol=0)
    assert any(float(v.abs().max()) > 0 for v in engine3.velocity.values())
    # a third epoch continues the run
    engine3.train(train_ds, val_ds, cfg.LEARNING_RATE, epochs=EPOCHS + 1,
                  log_fn=logs.append)
    assert engine3.step == (EPOCHS + 1) * cfg.STEPS_PER_EPOCH
    assert len(glob.glob(os.path.join(engine.log_dir, 'weights_*'))) == 3

    test_ds = _load(Urso, urso_dir, cfg, 'test')
    imgs = [test_ds.load_image(i) for i in range(cfg.BATCH_SIZE)]
    assert imgs[0].shape == (72, 96, 3)
    results = engine2.detect(imgs)
    molded = np.stack([jimage.mold_image(jimage.resize_image(
        im, min_dim=64, max_dim=64, mode='square')[0].astype(np.float32),
        cfg) for im in imgs])
    want = engine2.predict_molded(molded)
    for i, r in enumerate(results):
        assert r['loc'].shape == (3,) and r['ori'].shape == (6 ** 3,)
        for k in r:
            np.testing.assert_array_equal(r[k], want[k][i].numpy())


def test_resume_continues_the_draws(urso_dir, run_dir, monkeypatch):
    """Each step's rotation draws are keyed by the step, the validation's
    by the epoch and the resident permutation by the epoch: three epochs
    in one train() call and two, a resume in a fresh engine and a third
    draw the same, and end on the same weights exactly."""
    _, cfg = small_configs(STEPS_PER_EPOCH=2, VALIDATION_STEPS=1)
    train_ds = _load(Urso, urso_dir, cfg, 'train')
    val_ds = _load(Urso, urso_dir, cfg, 'val')
    drawn = []
    draw = tloader.DevicePreprocess.draw

    def record(self, generator, b):
        d = draw(self, generator, b)
        drawn.append({k: v.clone() for k, v in d.items()})
        return d

    monkeypatch.setattr(tloader.DevicePreprocess, 'draw', record)
    quiet = dict(log_fn=lambda *a: None)
    one = UrsoNet('training', cfg, str(run_dir / 'one'), device='cpu')
    one.initialize()
    one.train(train_ds, val_ds, None, epochs=3, **quiet)
    continuous, drawn[:] = list(drawn), []
    two = UrsoNet('training', cfg, str(run_dir / 'two'), device='cpu')
    two.initialize()
    two.train(train_ds, val_ds, None, epochs=2, **quiet)
    resumed = UrsoNet('training', cfg, str(run_dir / 'two'), device='cpu')
    assert resumed.resume_state(two.log_dir)
    resumed.train(train_ds, val_ds, None, epochs=3, **quiet)
    # 3 epochs of 2 train steps and 1 validation step
    assert len(drawn) == len(continuous) == 9
    for got, want in zip(drawn, continuous):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert any(not torch.equal(continuous[0][k], continuous[1][k])
               for k in continuous[0])
    for k, v in one.model.state_dict().items():
        torch.testing.assert_close(resumed.model.state_dict()[k], v, rtol=0,
                                   atol=0)


def test_checkpoint_keep_prunes_by_parsed_epoch(urso_dir, run_dir):
    _, cfg = small_configs(STEPS_PER_EPOCH=1, VALIDATION_STEPS=1,
                           CHECKPOINT_KEEP=2, ROT_AUG=False)
    engine = UrsoNet('training', cfg, str(run_dir / 'logs'), device='cpu')
    stray = engine.checkpoint_path.replace('*epoch*', 'best')
    os.makedirs(os.path.dirname(stray))
    open(stray, 'w').close()
    engine.train(_load(Urso, urso_dir, cfg, 'train'), None, None, epochs=4,
                 log_fn=lambda *a: None)
    left = sorted(os.path.basename(p) for p in
                  glob.glob(os.path.join(engine.log_dir, 'weights_*')))
    assert left == ['weights_ursonet_0002.msgpack',
                    'weights_ursonet_0003.msgpack',
                    'weights_ursonet_best.msgpack']


def test_engine_refuses_what_is_not_ported(tmp_path, monkeypatch):
    # Keras h5 files load through checkpoint/h5_import.py
    # (tests/test_torch_h5_import.py), Orbax directories through
    # checkpoint/orbax_store.py (tests/test_torch_orbax*.py)
    _, cfg = small_configs()
    engine = UrsoNet('inference', cfg, str(tmp_path), device='cpu')
    with pytest.raises(RuntimeError, match='training mode'):
        engine.train(None, None, None, 1)
    with pytest.raises(ValueError):
        UrsoNet('serving', cfg, str(tmp_path), device='cpu')
    assert not engine.resume_state(str(tmp_path))
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA'):
        UrsoNet('training', cfg, str(tmp_path))
    with pytest.raises(RuntimeError, match='CUDA'):
        tloader.load_dataset_resident(None, cfg)


def test_resident_step_matches_streaming(urso_dir):
    """The resident train step (an index gather of a permutation) equals
    the streaming step fed the same batch and the same draws (rotation
    augmentation on), as tests/test_engine.py holds the JAX package's;
    the resident eval step takes sequential positions."""
    _, cfg = small_configs()
    ds = _load(Urso, urso_dir, cfg, 'train')
    data, n = tloader.load_dataset_resident(ds, cfg, 'cpu')
    pre = tloader.make_device_preprocess(cfg, ds.camera, 'cpu', ds.name)
    perm = torch.randperm(n, generator=torch.Generator().manual_seed(4))
    metrics, params = [], []
    for resident in (True, False):
        model = build_model(cfg, 'cpu', torch.Generator().manual_seed(1))
        gen = torch.Generator().manual_seed(99)
        if resident:
            step = make_resident_train_step(model, cfg, make_optimizer(cfg),
                                            n, preprocess=pre, device='cpu')
            for i in range(2):
                i2, m = step(data, perm, i, gen)
                assert i2 == i + 1
        else:
            step = make_train_step(model, cfg, make_optimizer(cfg),
                                   preprocess=pre, device='cpu')
            for i in range(2):
                idx = perm[(i * 2 + torch.arange(2)) % n]
                m = step({k: v[idx] for k, v in data.items()}, gen)
        metrics.append({k: float(v) for k, v in m.items()})
        params.append(model.state_dict())
    assert metrics[0] == metrics[1]
    for k, v in params[0].items():
        torch.testing.assert_close(params[1][k], v, rtol=0, atol=0)
    # sequential validation positions, wrapping: 8 images, batch 2 -> 4
    # steps an epoch
    model = build_model(cfg, 'cpu', torch.Generator().manual_seed(1))
    rev = make_resident_eval_step(model, cfg, n, pre, 'cpu')
    sev = make_eval_step(model, cfg, pre, 'cpu')
    for i in (1, 5):
        _, got = rev(data, i, torch.Generator().manual_seed(3))
        pos = torch.tensor([2, 3])
        want = sev({k: v[pos] for k, v in data.items()},
                   torch.Generator().manual_seed(3))
        assert {k: float(v) for k, v in got.items()} == \
            {k: float(v) for k, v in want.items()}


def test_merge_params_matches_jax(urso_dir, run_dir):
    """Layer exclusion and shape-mismatch skips as the JAX package's
    merge_params, and the counterpart of tests/test_engine.py's partial
    load: excluded heads keep their fresh values, the backbone loads,
    and a load drops the quantized model."""
    jcfg, tcfg = small_configs()
    a = build_model(tcfg, 'cpu', torch.Generator().manual_seed(1))
    b_cfg = small_configs(ORI_BINS_PER_DIM=4)[1]
    b = build_model(b_cfg, 'cpu', torch.Generator().manual_seed(2))
    exclude = [r'loc_.*', r'bn5.*']
    got, loaded, skipped = store.merge_params(a.state_dict(), b.state_dict(),
                                              exclude)
    ta, tb = params_to_jax_layout(a.state_dict()), \
        params_to_jax_layout(b.state_dict())
    for section in ('params', 'batch_stats'):
        jm, jl, js = jstore.merge_params(ta[section], tb[section], exclude)
        _trees_equal(params_to_jax_layout(got)[section], jm, section)
        assert set(jl) <= set(loaded) and set(js) <= set(skipped)
    assert 'ori_final' in skipped and 'loc_final' in skipped
    assert 'res2a_branch2a' in loaded and 'bn5a_branch2a' in skipped

    engine = UrsoNet('training', tcfg, str(run_dir / 'a'), device='cpu')
    engine.initialize(seed=1)
    wpath = str(run_dir / 'w.msgpack')
    engine.save_weights(wpath)
    engine2 = UrsoNet('training', tcfg, str(run_dir / 'b'), device='cpu')
    engine2.initialize(seed=2)
    fresh = engine2.model.ori_head.ori_final.weight.clone()
    engine2.load_weights(wpath, exclude=[r'ori_.*', r'loc_.*'])
    torch.testing.assert_close(engine2.model.backbone.conv1.weight,
                               engine.model.backbone.conv1.weight, rtol=0,
                               atol=0)
    torch.testing.assert_close(engine2.model.ori_head.ori_final.weight,
                               fresh, rtol=0, atol=0)
    engine2.quantize()
    assert engine2.serving.qmodel is not None
    engine2.load_weights(wpath)
    assert engine2.serving.qmodel is None

