"""count.py's operations against torch.utils.flop_counter on the
program's float model at a small size, forward and a train step."""

from __future__ import annotations

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import common
import count
import program
from weights import make_weights


@pytest.mark.parametrize('name', [common.SERVE, common.SERVE_KP])
def test_count_matches_flop_counter(name):
    cell = common.tiny_serve(name)
    keys = dict(cell.config['config'], F16=False, IMAGES_PER_GPU=2)
    cfg = program.make_config(keys)
    h, w = int(cfg.IMAGE_SHAPE[0]), int(cfg.IMAGE_SHAPE[1])
    net = program.build_model(cfg, 'cpu')
    net.load_state_dict(make_weights(program.float_shapes(net), 1, 'cpu'))
    x = torch.randn(2, 3, h, w)
    with FlopCounterMode(display=False) as fc:
        out = net(x)
    fwd = fc.get_total_flops()
    assert fwd == 2 * count.train_flops(cell.model, h, w)['forward']
    with FlopCounterMode(display=False) as fc:
        out = net(x)
        sum(v.sum() for v in out.values()).backward()
    assert fc.get_total_flops() == \
        2 * count.train_flops(cell.model, h, w)['matmul']


def test_serve_bound_of_the_flagship():
    """PERF.md's bounds of the served flagship batch (128 x 512x640):
    GEMMs 5.1985 ms by bytes, 3x3 convs 1.5967 ms by operations, the stem
    0.0997 ms (197.3 GOP)."""
    m = common.cells.load_cell(common.SERVE).model
    b = count.serve_bound(m, 512, 640, 128)
    assert b['int8_gemm']['bound_s'] == pytest.approx(5.1985e-3, rel=1e-4)
    assert not b['int8_gemm']['by_ops']
    assert b['int8_conv']['bound_s'] == pytest.approx(1.5967e-3, rel=1e-4)
    assert b['int8_conv']['by_ops']
    assert b['int8_stem']['ops'] == pytest.approx(197.3e9, rel=1e-3)
