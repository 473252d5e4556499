"""The landmark model (BACKBONE 'hrnet_w32', `models/hrnet.py`) against the
benchmark's plain reference (`portbench/reference/hrnet_landmarks.py`) at
the published widths, on a 64x64 input at batch 2, float32 on the CPU:
the rendered targets and weights (one landmark outside the crop, one
whose window the crop cuts), the heatmaps, the loss, every parameter's
gradient, one AMSGrad step with the batch norms' running statistics, the
argmax decode; REMAT's gradients, `quantize()`'s refusal, the parameter
count against `portbench/count_hrnet.py`, and the float serving path.

Both sides take the same model batch (the program's preprocess output),
so that the comparisons see the model's and the step's arithmetic: the
targets are compared on their own. Tolerances are written where they
are used."""

from __future__ import annotations

import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from ursonet_torch.config import Config
from ursonet_torch.data.loader import make_device_preprocess
from ursonet_torch.engine import ServingEngine
from ursonet_torch.models import hrnet
from ursonet_torch.models.ursonet import build_model
from ursonet_torch.ops import landmarks as lm
from ursonet_torch.train.optim import make_optimizer
from ursonet_torch.train.step import make_train_step

PORTBENCH = Path(__file__).resolve().parents[1] / 'portbench'
if str(PORTBENCH) not in sys.path:
    sys.path.append(str(PORTBENCH))

import count_hrnet  # noqa: E402
from reference import hrnet_landmarks as R  # noqa: E402

SIZE, FOCAL, BATCH = 64, 250.0, 2
LR, WD, CLIP = 1e-3, 1e-4, 5.0
# body-frame landmarks (m): 9 inside a 1 m cube, one 3 m out along x (its
# 3-sigma window wholly outside the 16x16 heatmap at 10 m), one 1.3 m out
# (its window cut by the heatmap's edge)
LANDMARKS = np.concatenate([
    np.random.default_rng(11).uniform(-0.5, 0.5, (9, 3)),
    [[3.0, 0.0, 0.0], [1.3, 0.0, 0.0]]]).astype(np.float32)


def _config(remat=False, rotate=False):
    cfg = Config()
    cfg.BACKBONE = 'hrnet_w32'
    cfg.IMAGE_RESIZE_MODE = 'square'
    cfg.IMAGE_MIN_DIM = cfg.IMAGE_MAX_DIM = SIZE
    cfg.IMAGES_PER_GPU = BATCH
    cfg.TRAIN_BN = True
    cfg.REMAT = remat
    cfg.OPTIMIZER = 'ADAM'
    cfg.LEARNING_RATE, cfg.WEIGHT_DECAY, cfg.GRADIENT_CLIP_NORM = LR, WD, CLIP
    cfg.ROT_AUG = cfg.ROT_IMAGE_AUG = rotate
    cfg.LANDMARKS = LANDMARKS.tolist()
    cfg.update()
    return cfg


def _weights(model):
    """Seeded weights with batch norms away from the identity."""
    g = torch.Generator().manual_seed(5)
    out = {}
    for k, v in model.state_dict().items():
        if k.endswith(('running_var', 'bn1.weight', 'bn2.weight',
                       'bn3.weight', 'bn.weight')):
            out[k] = 0.8 + 0.4 * torch.rand(v.shape, generator=g)
        elif v.dim() >= 2:
            out[k] = torch.randn(v.shape, generator=g) \
                / np.sqrt(v[0].numel())
        else:
            out[k] = 0.05 * torch.randn(v.shape, generator=g)
    return out


def _raw():
    """Uniform pixels; the body at 10 and 11 m, unrotated (identity
    quaternions), so that the last two landmarks land where LANDMARKS
    says."""
    g = torch.Generator().manual_seed(9)
    return {'images_u8': torch.randint(0, 256, (BATCH, SIZE, SIZE, 3),
                                       generator=g, dtype=torch.uint8),
            'image_meta': torch.zeros(BATCH, 12),
            'location': torch.tensor([[0.1, -0.1, 10.0], [0.0, 0.2, 11.0]]),
            'quaternion': torch.tensor([[0.0, 0, 0, 1]] * BATCH)}


def _model(cfg, weights):
    net = build_model(cfg, 'cpu')
    net.load_state_dict(weights)
    return net


@pytest.fixture(scope='module')
def case():
    """The program's batch, model step and the reference on the same
    batch, computed once."""
    torch.manual_seed(0)
    cfg = _config()
    k_cam = R.speed_crop_k(SIZE, FOCAL)
    camera = types.SimpleNamespace(K=k_cam, height=SIZE, width=SIZE)
    pre = make_device_preprocess(cfg, camera, 'cpu', 'speed')
    raw = _raw()
    batch = pre(raw)
    net = _model(cfg, _weights(build_model(cfg, 'cpu')))
    weights = {k: v.clone() for k, v in net.state_dict().items()}
    names = [n for n, _ in net.named_parameters()]
    rec = dict(rot_aug=False, rot_image_aug=False, k_net=k_cam,
               mean=np.asarray(cfg.MEAN_PIXEL, np.float32),
               landmarks=LANDMARKS, sigma=float(cfg.HEATMAP_SIGMA),
               heatmap_hw=R.heatmap_hw(SIZE, SIZE))
    ref = R.LandmarkReference(weights, names, rec,
                              dict(lr=LR, clip=CLIP, weight_decay=WD))
    ref_batch = {'images': batch['images'], 'target': batch['gt_heatmaps'],
                 'weight': batch['gt_weights']}
    # the forward and the gradient of both, before any step
    net.train()
    heat = net(batch['images'])['heatmaps']
    from ursonet_torch.train import losses as L
    loss = L.joints_mse(heat, batch['gt_heatmaps'], batch['gt_weights']) \
        + L.l2_regularization(net, WD)
    grads = torch.autograd.grad(loss, list(net.parameters()))
    r_loss, _, r_heat = ref.loss(ref_batch)
    r_grads = torch.autograd.grad(r_loss, [ref.params[n] for n in names])
    # one step of each
    tx = make_optimizer(cfg)
    step = make_train_step(net, cfg, tx, device='cpu')
    metrics = step({k: v for k, v in batch.items()})
    ref.step_batch(ref_batch)
    return types.SimpleNamespace(
        cfg=cfg, raw=raw, batch=batch, ref=ref, rec=rec, net=net,
        names=names, weights=weights, heat=heat, loss=loss, grads=grads,
        r_heat=r_heat, r_loss=r_loss, r_grads=r_grads, metrics=metrics)


def test_targets_and_weights_match_the_reference(case):
    # the reference's batch (its own projection and generate_target):
    # weights exactly; targets within 2e-7 (float32 exp of the same
    # argument, numpy's against torch's: an ulp of values <= 1); pixels
    # within 1e-4 px (float32 rounding at ~30 px, two formula orders)
    got = case.ref.batch(case.raw, torch.Generator().manual_seed(0))
    heat, wgt = case.batch['gt_heatmaps'], case.batch['gt_weights']
    assert torch.equal(wgt, got['weight'])
    assert torch.allclose(heat, got['target'], rtol=0, atol=2e-7)
    assert torch.allclose(case.batch['gt_landmarks'], got['pixels'],
                          rtol=0, atol=1e-4)
    assert torch.equal(case.batch['images'], got['images'])
    # 3 m out along x: the window wholly outside, dropped, all zero
    assert wgt[:, 9].eq(0).all() and heat[:, 9].eq(0).all()
    # 1.3 m out: kept, its window cut by the heatmap's right edge (at 10 m
    # its centre lies past it, at 11 m on its last column)
    assert wgt[:, 10].eq(1).all()
    assert (heat[:, 10, :, -1] > 0).any(-1).all()
    assert float(heat[0, 10].max()) < 1.0 == float(heat[1, 10].max())
    assert wgt[:, :9].eq(1).all()


def test_heatmaps_and_loss_match_the_reference(case):
    # the same operations on the same inputs; 1e-5 relative covers the
    # CPU threads' summation order through 100-odd layers
    assert case.heat.shape == (BATCH, 11, 16, 16)
    scale = float(case.r_heat.detach().abs().max())
    gap = (case.heat - case.r_heat).detach().abs().max()
    assert float(gap) <= 1e-5 * scale
    want = float(case.r_loss.detach())
    assert float(case.loss.detach()) == pytest.approx(want, rel=1e-5)


def test_every_gradient_matches_the_reference(case):
    # per leaf, against 1e-4 of its own norm plus 1e-5 of the median
    # leaf's: a batch-statistics BN's bias gradient is the small remainder
    # of terms that cancel, so its rounding is that of the terms, not of
    # the remainder
    norms = [float(g.norm()) for g in case.r_grads]
    med = float(np.median(norms))
    for n, g, r, rn in zip(case.names, case.grads, case.r_grads, norms):
        assert float((g - r).norm()) <= 1e-4 * rn + 1e-5 * med, n


def test_one_amsgrad_step_and_bn_statistics_match_the_reference(case):
    # AMSGrad's first update is lr·g/(|g| + eps): an element whose
    # gradient rounds to the other sign moves 2·lr the other way, so the
    # changes are compared as one vector (under 1e-3 of its norm), and
    # every element within 2·lr
    net, ref = case.net, case.ref
    got = torch.cat([(p.detach() - case.weights[n]).flatten()
                     for n, p in net.named_parameters()])
    want = torch.cat([(ref.params[n] - case.weights[n]).flatten()
                      for n in case.names])
    assert float((got - want).norm()) <= 1e-3 * float(want.norm())
    assert float((got - want).abs().max()) <= 2 * LR * (1 + 1e-5)
    assert float(case.metrics['loss']) == pytest.approx(
        float(case.r_loss.detach()), rel=1e-5)
    # running statistics: the forward's statistics alone, 1e-5 relative
    bufs = dict(net.named_buffers())
    assert len(ref.buffers) == 2 * 292
    for n, v in ref.buffers.items():
        assert torch.allclose(bufs[n], v, rtol=1e-5, atol=1e-6), n


def test_rotated_targets_follow_the_reference_augmentation(case):
    # ROT_AUG and ROT_IMAGE_AUG on both sides, drawn from equal
    # generators: the same images (nearest sampling of the same pixels),
    # the same weights, targets within an ulp (as above)
    cfg = _config(rotate=True)
    camera = types.SimpleNamespace(K=case.rec['k_net'], height=SIZE,
                                   width=SIZE)
    pre = make_device_preprocess(cfg, camera, 'cpu', 'speed')
    for seed in (1, 2, 3):
        batch = pre(case.raw, pre.draw(torch.Generator().manual_seed(seed),
                                       BATCH))
        ref = R.LandmarkReference({}, [], dict(case.rec, rot_aug=True,
                                               rot_image_aug=True), {})
        got = ref.batch(case.raw, torch.Generator().manual_seed(seed))
        assert torch.equal(got['images'], batch['images'])
        assert torch.equal(got['weight'], batch['gt_weights'])
        assert torch.allclose(got['target'], batch['gt_heatmaps'], rtol=0,
                              atol=2e-7)


def test_decode_matches_hrnet(case):
    # exact: argmax, the positive-maximum mask and the quarter shift are
    # comparisons and constants
    heat = case.heat.detach()
    heat[0, 0] = -1.0                       # no positive maximum: (0, 0)
    heat[1, 1] = 0.0
    heat[1, 1, 0, 7] = 2.0                  # on the edge: no shift
    px, score = lm.decode(heat, lm.HEATMAP_STRIDE)
    want, maxvals = R.final_preds(heat.numpy())
    assert np.array_equal(px.numpy(), want)
    assert np.array_equal(score.numpy(), maxvals[..., 0])
    assert px[0, 0].eq(0).all() and px[1, 1].tolist() == [28.0, 0.0]


def test_remat_gives_the_same_gradients(case):
    # the recompute repeats the same arithmetic on the same inputs
    out = {}
    for remat in (False, True):
        cfg = _config(remat)
        net = _model(cfg, case.weights)
        net.train()
        heat = net(case.batch['images'])['heatmaps']
        loss = 0.5 * torch.mean(heat ** 2)
        out[remat] = torch.autograd.grad(loss, list(net.parameters()))
    for a, b in zip(out[False], out[True]):
        assert torch.allclose(a, b, rtol=1e-6, atol=0)


def test_quantize_refuses_the_landmark_model():
    cfg = _config()
    with pytest.raises(ValueError, match='float only'):
        ServingEngine(cfg, 'cpu').quantize()


def test_parameter_count_matches_count_hrnet(case):
    n = sum(p.numel() for p in case.net.parameters())
    assert n == count_hrnet.params(11) == 28_535_915
    # the preprocess renders targets for exactly the heatmap backbones
    assert set(lm.HEATMAP_BACKBONES) == set(hrnet.HRNET_WIDTHS)


def test_float_serving_returns_heatmaps_and_landmarks(case):
    eng = ServingEngine(case.cfg, 'cpu', model=case.net)
    molded = np.random.default_rng(2).uniform(
        -100, 100, (BATCH, SIZE, SIZE, 3)).astype(np.float32)
    out = eng.predict_molded(molded)
    assert out['heatmaps'].shape == (BATCH, 11, 16, 16)
    want, maxvals = R.final_preds(out['heatmaps'].numpy())
    assert np.array_equal(out['landmarks'].numpy(), want)
    assert np.array_equal(out['landmark_scores'].numpy(), maxvals[..., 0])
