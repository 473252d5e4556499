"""chip_smoke.py's TRAIN_ACT_Q8 phase (`run_actq`, `run_actq_cli`,
`run_actq_phase`: phase 8g) at a small size on the CPU, where every
kernel runs its plain version in the layouts the card's kernels read:
`small_config()` (ResNet-50 at 64x64, whose 52 convs of 64 channels or
more take wgrad_s8's 'tma' route and whose stem takes the ragged one)
under TRAIN_ACT_Q8 False, True and 'wgrad8'; then config 5's recipe
(REMAT), config 2's through the command line and the f32 flagship's.

Tolerances: run_actq raises on any difference it checks (the first
step's loss across the modes, each distinct quant_s8 / wgrad_s8 call
against its plain version on both routes and under a group: all exact).
"""

import torch

import chip_smoke
from ursonet_torch.data.synthetic import make_urso_dataset
from ursonet_torch.ops import actq_cuda
# run_dir is a fixture
from torch_parity import run_dir  # noqa: F401
from test_torch_config2_phase import SMALL_FLAGS

torch.set_num_threads(2)


def test_chip_smoke_actq_phase_on_cpu():
    out = chip_smoke.run_actq('cpu', 0, cfg=chip_smoke.small_config(),
                              steps=2, timed=False)
    w8 = out['modes']['wgrad8']['kernels']
    assert dict(w8['wgrad_s8']['routes']) == {'tma': 52, 'ragged': 1}
    assert dict(w8['quant_s8']['modes']) == {'x': 53, 'g': 53}
    assert dict(out['modes'][True]['kernels']['quant_s8']['modes']) \
        == {'x': 53, 'dequant': 53}
    assert w8['wgrad_s8']['ops'] > 0 and w8['quant_s8']['bytes'] > 0
    # on the CPU nothing launches
    assert actq_cuda.launches == {'quant_s8': 0, 'wgrad_s8': 0}
    assert not any(actq_cuda.kernel_launches.values())


def test_chip_smoke_actq_recipes_on_cpu(run_dir):
    """Phase 8g's other recipes at a small size: config 5's (keypoints,
    F16, REMAT; ResNet-50 standing for its ResNet-101) with the no-REMAT
    steps beside it, config 2 through the command line at batch 1 (the
    stem's weight gradient on the gather route, checked against
    im2col_torch) and the f32 flagship's: each step's calls as
    `actq_expected` counts them, the first step's loss equal across the
    modes, REMAT's gradients equal to those without."""
    root = str(run_dir)
    make_urso_dataset(root + '/urso',
                      n_per_subset={'train': 4, 'val': 2, 'test': 3},
                      width=256, height=192, seed=0)
    c5 = chip_smoke.small_config(5)
    c5.BACKBONE = 'resnet50'
    c5.update()
    out = chip_smoke.run_actq_phase(
        root, 'cpu', 0, recipes=(('config5', c5),
                                 ('f32', chip_smoke.small_config(3))),
        cli_flags=SMALL_FLAGS, cli_steps=2, steps=2, timed=False)
    r5 = out['recipes']['config5']['modes']
    assert r5[True]['expected'] == {
        'quant_s8_x': 53 + 52, 'quant_s8_g': 0, 'quant_s8_dequant': 53,
        'wgrad_s8_tma': 0, 'wgrad_s8_ragged': 0}
    assert r5['wgrad8']['no_remat']['expected']['quant_s8_x'] == 53
    assert dict(r5['wgrad8']['kernels']['quant_s8']['modes']) \
        == {'x': 105, 'g': 53}
    cli = out['recipes']['config2 CLI']['modes']['wgrad8']
    assert cli['expected'] == {
        'quant_s8_x': 21, 'quant_s8_g': 21, 'quant_s8_dequant': 0,
        'wgrad_s8_tma': 20, 'wgrad_s8_ragged': 1}
    assert cli['kernels']['im2col_s8']['distinct'] == 1
    assert dict(out['recipes']['f32']['modes']['wgrad8']['kernels']
                ['wgrad_s8']['routes']) == {'tma': 52, 'ragged': 1}
    assert set(out['recipes']) == {'config5', 'config2 CLI', 'f32'}
    # the kernels line's rows of the phase: every key the line needs,
    # and the launches of each path
    rows = {r['name']: r for r in chip_smoke.actq_kernel_rows(out)}
    assert set(rows) == {'quant_s8', 'wgrad_s8', 'quant_s8_dequant',
                         'im2col_s8'}
    for r in rows.values():
        assert {'name', 'route', 'source', 'replaces', 'launches',
                'max_abs_err', *chip_smoke.LINE_KEYS} <= set(r)
        assert set(r['launches_by_path']) == set(out['recipes'])
    assert rows['im2col_s8']['replaces'] == 'ursonet_tpu/models/actq.py:90'
