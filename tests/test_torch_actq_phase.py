"""chip_smoke.py's TRAIN_ACT_Q8 phase (`run_actq`, phase 8g) at a small
size on the CPU, where every kernel runs its plain version in the layouts
the card's kernels read: `small_config()` (ResNet-50 at 64x64, whose 52
convs of 64 channels or more take wgrad_s8's 'tma' route and whose stem
takes the ragged one) under TRAIN_ACT_Q8 False, True and 'wgrad8'.

Tolerances: run_actq raises on any difference it checks (the first
step's loss across the modes, each distinct quant_s8 / wgrad_s8 call
against its plain version on both routes and under a group: all exact).
"""

import torch

import chip_smoke
from ursonet_torch.ops import actq_cuda

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
