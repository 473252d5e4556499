"""The port's profiling helpers (`ursonet_torch/utils/profiling.py`)
against the JAX package's `utils/profiling.py` on the CPU.

`get_flops`: XLA's cost model and PyTorch's FlopCounterMode agree on a
matrix product and on a bias-free VALID conv (2 operations a
multiply-add). Stated deviation, checked here: under 'SAME' padding XLA
counts only the taps inside the image, PyTorch every tap of the padded
window; and PyTorch's counter does not count elementwise operations."""

import json

import numpy as np
import torch
import torch.nn.functional as F

import jax.numpy as jnp
from jax import lax

from ursonet_tpu.utils import profiling as jprof
from ursonet_torch.utils import profiling as tprof


def _conv_inputs():
    rng = np.random.RandomState(0)
    x = rng.rand(2, 16, 16, 8).astype(np.float32)
    w = rng.rand(3, 3, 8, 12).astype(np.float32)
    return x, w, torch.from_numpy(x.transpose(0, 3, 1, 2).copy()), \
        torch.from_numpy(w.transpose(3, 2, 0, 1).copy())


def _jconv(padding):
    return lambda x, w: lax.conv_general_dilated(
        x, w, (1, 1), padding, dimension_numbers=('NHWC', 'HWIO', 'NHWC'))


def test_flops_of_a_valid_conv_and_a_matmul_are_jaxs():
    x, w, xt, wt = _conv_inputs()
    want = jprof.get_flops(_jconv('VALID'), x, w)
    assert tprof.get_flops(lambda a, b: F.conv2d(a, b), xt, wt) == want \
        == 2 * 2 * 14 * 14 * 12 * 8 * 9
    a = np.random.RandomState(1).rand(64, 32).astype(np.float32)
    b = np.random.RandomState(2).rand(32, 48).astype(np.float32)
    assert tprof.get_flops(torch.matmul, torch.from_numpy(a),
                           torch.from_numpy(b)) \
        == jprof.get_flops(jnp.matmul, a, b) == 2 * 64 * 32 * 48


def test_flops_deviations():
    x, w, xt, wt = _conv_inputs()
    dense = 2 * 2 * 16 * 16 * 12 * 8 * 9
    assert tprof.get_flops(lambda a, b: F.conv2d(a, b, padding=1), xt,
                           wt) == dense
    assert jprof.get_flops(_jconv('SAME'), x, w) < dense
    assert tprof.get_flops(lambda a: a * 2 + 1, xt) == 0
    got = tprof.cost_analysis(lambda a, b: F.conv2d(a, b), xt, wt)
    assert set(got) == {'flops', 'flops_by_op'}
    assert sum(got['flops_by_op'].values()) == got['flops']


def test_log_tensor_stats_text_is_jaxs():
    rng = np.random.RandomState(3)
    cases = [('images', (rng.rand(2, 5, 3) * 100).astype(np.float32)),
             ('empty', np.zeros((0, 3), np.float32)),
             ('ids', rng.randint(-5, 9, (7,)).astype(np.int64)),
             ('a long name beyond 25 chars', rng.randn(3).astype(np.float64))]
    for text, a in cases:
        want, got = [], []
        jprof.log_tensor_stats(text, a, log_fn=want.append)
        tprof.log_tensor_stats(text, torch.from_numpy(a),
                               log_fn=got.append)
        tprof.log_tensor_stats(text, a, log_fn=got.append)
        assert got == want * 2
    got, want = [], []
    jprof.log_tensor_stats('only text', log_fn=want.append)
    tprof.log_tensor_stats('only text', log_fn=got.append)
    assert got == want


def test_trace_writes_a_chrome_trace(tmp_path):
    with tprof.trace(str(tmp_path)):
        torch.ones(8) @ torch.ones(8)
    with open(tmp_path / 'trace.json') as f:
        events = json.load(f)['traceEvents']
    assert any('matmul' in e.get('name', '') or 'dot' in e.get('name', '')
               for e in events)
