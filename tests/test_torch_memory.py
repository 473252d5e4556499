"""The port's train-memory estimate (`ursonet_torch/utils/memory.py`):
its structural estimate equals the JAX package's exactly for every
benchmark configuration and mode, and its calibrated estimate (the
structure times the eager step's factor per mode) reproduces the peaks
the factors were calibrated on, within the ±25% that chip_smoke.py holds
each train configuration to on the card."""

import math

import pytest

from ursonet_tpu import presets as jpresets
from ursonet_tpu.utils import memory as jmemory
from ursonet_torch import presets as tpresets
from ursonet_torch.utils import memory as tmemory

# peaks of one eager train step on an NVIDIA H100 80GB HBM3 at 700 W
# (chip_smoke.py phases 4-6), bytes, with the overrides of the
# configuration: the flagship in f32 and F16, config 5 with and without
# REMAT, the engine's config 3
PEAKS = [
    (3, {'IMAGES_PER_GPU': 32}, 17.57 * 2 ** 30),
    (3, {'IMAGES_PER_GPU': 32, 'F16': True}, 9.51 * 2 ** 30),
    (5, {}, 3.32 * 2 ** 30),
    (5, {'REMAT': False}, 7.13 * 2 ** 30),
    (3, {'IMAGES_PER_GPU': 32}, 19.02e9),
]


def _both(n, **overrides):
    cfgs = []
    for presets in (jpresets, tpresets):
        cfg = presets.benchmark_config(n)
        for k, v in overrides.items():
            setattr(cfg, k, v)
        cfg.update()
        cfgs.append(cfg)
    return cfgs


@pytest.mark.parametrize('overrides', [{}, {'F16': True}, {'REMAT': True},
                                       {'F16': True, 'REMAT': 'narrow'},
                                       {'IMAGES_PER_GPU': 7}])
@pytest.mark.parametrize('n', [1, 2, 3, 4, 5])
def test_structural_estimate_equals_jax(n, overrides):
    jcfg, tcfg = _both(n, **overrides)
    assert tmemory.estimate_train_hbm_gb(tcfg) == \
        jmemory.estimate_train_hbm_gb(jcfg)


@pytest.mark.parametrize('n,overrides,peak', PEAKS)
def test_calibrated_estimate_within_a_quarter_of_the_peaks(n, overrides,
                                                           peak):
    _, cfg = _both(n, **overrides)
    est = tmemory.calibrated_train_gb(cfg)
    mode = tmemory.eager_mode(cfg)
    assert est == tmemory.EAGER_FACTORS[mode] * \
        tmemory.estimate_train_hbm_gb(cfg)
    assert abs(est * 1e9 / peak - 1) <= 0.25
    # on the CPU there is no card to warn about; the figure is returned
    warnings = []
    assert tmemory.check_train_memory(cfg, 'cpu', warnings.append) == est
    assert warnings == []


def test_eager_modes():
    _, cfg = _both(3)
    assert tmemory.eager_mode(cfg) == 'f32'
    cfg.F16 = True
    assert tmemory.eager_mode(cfg) == 'f16'
    cfg.REMAT = 'narrow'
    assert tmemory.eager_mode(cfg) == 'remat'
    cfg.F16 = False
    assert tmemory.eager_mode(cfg) == 'remat'


def test_f32_remat_is_said_to_be_uncalibrated():
    """No f32 step under REMAT was measured: its figure borrows the F16
    REMAT factor, and check_train_memory says so; the measured modes say
    nothing on the CPU."""
    _, cfg = _both(3, REMAT=True)
    assert not tmemory.calibrated(cfg)
    notes = []
    est = tmemory.check_train_memory(cfg, 'cpu', notes.append)
    assert est == tmemory.EAGER_FACTORS['remat'] * \
        tmemory.estimate_train_hbm_gb(cfg)
    assert len(notes) == 1 and 'uncalibrated' in notes[0]
    for overrides in ({}, {'F16': True}, {'F16': True, 'REMAT': True}):
        _, cfg = _both(3, **overrides)
        assert tmemory.calibrated(cfg)


@pytest.mark.parametrize('arch', ['resnet18', 'resnet34'])
def test_shallow_backbones_are_said_to_be_uncalibrated(arch):
    """The factors were fitted on bottleneck backbones: a ResNet-18/34
    estimate says so, in every mode."""
    for overrides in ({}, {'F16': True}, {'REMAT': True}):
        _, cfg = _both(2, BACKBONE=arch, **overrides)
        assert not tmemory.calibrated(cfg)
        notes = []
        est = tmemory.check_train_memory(cfg, 'cpu', notes.append)
        assert est == tmemory.calibrated_train_gb(cfg)
        assert len(notes) == 1 and 'uncalibrated' in notes[0] \
            and arch in notes[0]


class _Cfg:
    """The fields backbone_convs and actq_saved_gb read."""

    def __init__(self, arch, batch, hw, mode, inner=1.0, remat=False):
        self.BACKBONE, self.BATCH_SIZE, self.IMAGE_SHAPE = arch, batch, hw
        self.TRAIN_ACT_Q8, self.INNER_WIDTH_MULT = mode, inner
        self.REMAT = remat


@pytest.mark.parametrize('arch,inner,remat',
                         [('resnet50', 1.0, False), ('resnet50', 0.6, False),
                          ('resnet18', 1.0, False), ('resnet50', 1.0, True),
                          ('resnet50', 1.0, 'narrow'),
                          ('resnet18', 1.0, True)])
@pytest.mark.parametrize('mode', [True, 'wgrad8'])
def test_actq_saved_bytes_are_the_models(arch, inner, remat, mode,
                                         monkeypatch):
    """backbone_convs lists the inputs that the backbone's ConvQ8s
    quantize, in order, and actq_saved_gb counts the most bytes of the q
    they save (in the layout each one's backward reads: plain, or the TMA
    route's column copies under 'wgrad8') that one train step holds at
    once: every conv's without REMAT; under REMAT, whose checkpoints drop
    the copies of the convs inside them and remake them in the backward,
    what the model's own 'x' calls leave alive at their most, measured
    over a forward and a backward."""
    import gc
    import weakref

    import torch

    from ursonet_torch.models.resnet import make_backbone
    from ursonet_torch.ops import actq_cuda
    seen, live = [], {'now': 0, 'most': 0}
    quant = actq_cuda.quant_s8

    def freed(nbytes):
        live['now'] -= nbytes

    def spy(t, m, *a, **kw):
        out = quant(t, m, *a, **kw)
        if m == 'x':
            q = out[0]
            seen.append((tuple(t.shape), q.numel()))
            live['now'] += q.numel()
            live['most'] = max(live['most'], live['now'])
            weakref.finalize(q, freed, q.numel())
        return out
    monkeypatch.setattr(actq_cuda, 'quant_s8', spy)
    torch.manual_seed(0)
    net = make_backbone(arch, inner_mult=inner, act_q8=mode, remat=remat)
    net(torch.randn(2, 3, 64, 80)).sum().backward()
    del net
    gc.collect()
    assert live['now'] == 0
    cfg = _Cfg(arch, 2, (64, 80, 3), mode, inner, remat)
    convs = tmemory.backbone_convs(cfg)
    forward = [s for s, _ in seen[:len(convs)]]
    assert forward == [c[:4] for c in convs]
    # the recompute quantizes again what its checkpoints recompute
    assert len(seen) > len(convs) if remat else len(seen) == len(convs)
    assert tmemory.actq_saved_gb(cfg) * 1e9 == pytest.approx(
        live['most'], abs=0.5)
    if not remat:
        assert live['most'] == sum(b for _, b in seen)
    if mode == 'wgrad8' and arch == 'resnet50' and not remat:
        # the 3x3 convs' column copies make q larger than the input
        assert sum(b for _, b in seen) > sum(
            math.prod(s) for s, _ in seen)
    else:
        assert tmemory.actq_saved_gb(_Cfg(arch, 2, (64, 80, 3), False,
                                          inner, remat)) == 0.0


def test_actq_saved_bytes_join_the_calibrated_estimate():
    _, cfg = _both(3, IMAGES_PER_GPU=32, F16=True)
    base = tmemory.calibrated_train_gb(cfg)
    for mode in (True, 'wgrad8'):
        cfg.TRAIN_ACT_Q8 = mode
        extra = tmemory.actq_saved_gb(cfg)
        assert extra > 0
        assert tmemory.calibrated_train_gb(cfg) == base + extra
