"""The port's spans (`ursonet_torch/utils/profiling.py::span`) on the CPU:
without a profiler `span` hands out one shared no-op context; under
`torch.profiler` a served batch and a resident train step emit each of
their spans once, nested and in graph order; and the outputs, losses
and updated parameters are the same bits with and without a profiler.

Sizes as the other CPU tests (tests/torch_parity.py::small_configs:
ResNet-50 at 64x64, narrow heads, batch 2; ResNet-18 for the basic
backbone), the int8 model on its plain route."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ursonet_torch.data import loader as tloader
from ursonet_torch.data.synthetic import make_urso_dataset
from ursonet_torch.data.urso import Urso
from ursonet_torch.engine import ServingEngine
from ursonet_torch.models.ursonet import build_model
from ursonet_torch.train.optim import make_optimizer
from ursonet_torch.train.step import make_resident_train_step
from ursonet_torch.utils import profiling
from torch_parity import small_configs

torch.set_num_threads(1)

SERVE = ('ursonet.serve.predict', 'ursonet.serve.pack',
         'ursonet.serve.h2d', 'ursonet.serve.forward')
STAGES = ('ursonet.qmodel.stem', 'ursonet.qmodel.res2',
          'ursonet.qmodel.res3', 'ursonet.qmodel.res4',
          'ursonet.qmodel.res5', 'ursonet.qmodel.head')
TRAIN = ('ursonet.train.preprocess', 'ursonet.train.forward',
         'ursonet.train.backward', 'ursonet.train.update')


def _traced(fn):
    """fn() under a CPU profiler: (its result, [(span name, start, end)]
    of the 'ursonet.' spans, by start)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = sorted(((e.name, e.time_range.start, e.time_range.end)
                    for e in prof.events() if e.name.startswith('ursonet.')),
                   key=lambda s: s[1])
    return out, spans


def _one_each(spans, names):
    """{name: (start, end)}, checking that each of `names` came once and
    that no other span came."""
    got = [n for n, _, _ in spans]
    assert sorted(got) == sorted(names), got
    return {n: (s, e) for n, s, e in spans}


def _inside(at, outer, inner):
    return at[outer][0] <= at[inner][0] and at[inner][1] <= at[outer][1]


def _in_order(at, names):
    """Each span ends before the next one starts."""
    return all(at[a][1] <= at[b][0] for a, b in zip(names, names[1:]))


def test_span_without_a_profiler_is_one_shared_no_op():
    a, b = profiling.span('ursonet.a'), profiling.span('ursonet.b')
    assert a is b
    with a:
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        on = profiling.span('ursonet.a')
    assert on is not a
    assert profiling.span('ursonet.a') is a


def _u8_batch(seed, n=2, dim=64):
    return np.random.RandomState(seed).randint(0, 256, (n, dim, dim, 3)) \
        .astype(np.uint8)


@pytest.fixture(scope='module', params=['resnet50', 'resnet18'])
def int8_engine(request):
    _, cfg = small_configs(BACKBONE=request.param)
    eng = ServingEngine(cfg, device='cpu',
                        generator=torch.Generator().manual_seed(3))
    eng.quantize(list(_u8_batch(4)))
    return eng


def test_int8_predict_emits_each_serving_span_once_in_graph_order(
        int8_engine):
    _, spans = _traced(lambda: int8_engine.predict_molded(_u8_batch(5)))
    at = _one_each(spans, SERVE + STAGES)
    for name in SERVE[1:]:
        assert _inside(at, 'ursonet.serve.predict', name), name
    assert _in_order(at, SERVE[1:])
    for name in STAGES:
        assert _inside(at, 'ursonet.serve.forward', name), name
    assert _in_order(at, STAGES)


def test_float_predict_emits_h2d_then_forward():
    _, cfg = small_configs()
    eng = ServingEngine(cfg, device='cpu',
                        generator=torch.Generator().manual_seed(1))
    x = np.random.RandomState(12).randn(2, 64, 64, 3).astype(np.float32) * 50
    _, spans = _traced(lambda: eng.predict_molded(x))
    at = _one_each(spans, ('ursonet.serve.predict', 'ursonet.serve.h2d',
                           'ursonet.serve.forward'))
    assert _inside(at, 'ursonet.serve.predict', 'ursonet.serve.h2d')
    assert _inside(at, 'ursonet.serve.predict', 'ursonet.serve.forward')
    assert _in_order(at, ('ursonet.serve.h2d', 'ursonet.serve.forward'))


@pytest.mark.parametrize('quantized', [True, False])
def test_served_heads_are_the_same_bits_under_a_profiler(int8_engine,
                                                         quantized):
    if quantized:
        eng, x = int8_engine, _u8_batch(6)
    else:
        _, cfg = small_configs()
        eng = ServingEngine(cfg, device='cpu',
                            generator=torch.Generator().manual_seed(1))
        x = np.random.RandomState(13).randn(2, 64, 64, 3) \
            .astype(np.float32) * 50
    plain = eng.predict_molded(x)
    traced, _ = _traced(lambda: eng.predict_molded(x))
    assert plain.keys() == traced.keys()
    for k in plain:
        torch.testing.assert_close(traced[k], plain[k], rtol=0, atol=0)


@pytest.fixture(scope='module')
def resident(tmp_path_factory):
    """A resident URSO dataset of 8 frames at 96x72, its preprocess with
    the rotation augmentation, and the small configuration."""
    d = str(tmp_path_factory.mktemp('urso'))
    make_urso_dataset(d, subsets=('train',), n_per_subset=8, width=96,
                      height=72)
    _, cfg = small_configs()
    ds = Urso()
    ds.load_dataset(d, cfg, 'train')
    data, n = tloader.load_dataset_resident(ds, cfg, 'cpu')
    pre = tloader.make_device_preprocess(cfg, ds.camera, 'cpu', ds.name)
    return cfg, data, n, pre


def _train_once(resident, traced):
    """One resident step from seeded weights and draws, under a CPU
    profiler where `traced`: (metrics, parameters, spans)."""
    cfg, data, n, pre = resident
    model = build_model(cfg, 'cpu', torch.Generator().manual_seed(1))
    step = make_resident_train_step(model, cfg, make_optimizer(cfg), n,
                                    preprocess=pre, device='cpu')
    perm = torch.randperm(n, generator=torch.Generator().manual_seed(4))

    def run():
        return step(data, perm, 1, torch.Generator().manual_seed(99))[1]

    metrics, spans = _traced(run) if traced else (run(), [])
    return metrics, model.state_dict(), spans


def test_resident_step_emits_gather_then_the_step_phases(resident):
    _, _, spans = _train_once(resident, traced=True)
    at = _one_each(spans, ('ursonet.train.gather', 'ursonet.train.step')
                   + TRAIN)
    assert _in_order(at, ('ursonet.train.gather', 'ursonet.train.step'))
    for name in TRAIN:
        assert _inside(at, 'ursonet.train.step', name), name
    assert _in_order(at, TRAIN)


def test_train_step_is_the_same_bits_under_a_profiler(resident):
    m0, p0, _ = _train_once(resident, traced=False)
    m1, p1, _ = _train_once(resident, traced=True)
    assert m0.keys() == m1.keys()
    for k in m0:
        torch.testing.assert_close(m1[k], m0[k], rtol=0, atol=0)
    assert p0.keys() == p1.keys()
    for k in p0:
        torch.testing.assert_close(p1[k], p0[k], rtol=0, atol=0)
