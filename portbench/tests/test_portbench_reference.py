"""The plain int8 serving reference against the program's plain int8
path at a small size: the same weights and calibration images give the
same heads, bit for bit (the reference works out the folding, the
calibration, the migration, the bias correction and the epilogues
itself)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import common
import inputs
import program
from reference.int8_serve import Int8Reference
from weights import make_weights


@pytest.mark.parametrize('name', [common.SERVE, common.SERVE_KP])
def test_reference_equals_the_plain_path(name):
    cell = common.tiny_serve(name)
    tr = cell.traffic
    cfg = program.make_config(dict(cell.config['config'], **tr['config'],
                                   IMAGES_PER_GPU=4))
    h, w = int(cfg.IMAGE_SHAPE[0]), int(cfg.IMAGE_SHAPE[1])
    net = program.build_model(cfg, 'cpu')
    weights = make_weights(program.float_shapes(net), 7, 'cpu')
    net.load_state_dict(weights)
    (images,) = inputs.image_pool(7, 1, 4, h, w, 'cpu')
    qm = program.serving_engine(cfg, 'cpu', net).quantize()
    qm.calibrate(images)
    qm.smooth(0.5)
    qm.bias_correct(images, passes=1)
    got = qm(images, plain=True)
    ref = Int8Reference(weights, cell.model, 'cpu')
    ref.prepare(torch.from_numpy(images), 0.5, 1)
    want = ref.serve(torch.from_numpy(images))
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k].float(), want[k]), k
    assert ref.scales == pytest.approx(qm.act_scales, rel=0, abs=0)
    for site, d in ref.delta.items():
        np.testing.assert_array_equal(d, qm.bias_delta[site])
