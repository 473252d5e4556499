"""chip_smoke.py's serving-knobs phase (`run_knobs`, phase 8d) at a small
size on the CPU, where every kernel runs its plain version: the flagship
served under QUANT_S8_JOIN (base, host_s2d, f32 epilogues,
bias_correct), the float residual join, QUANT_BF16_STEM (base, s2d) and
the float head knobs beside the default batches; config 2 under
QUANT_S8_JOIN and the head knobs; the flagship pruned to 0.5 and 0.6 by
`python -m ursonet_torch.prune_inner`, served; two F16 train steps of
the pruned flagship from the pruned weights.

Tolerances: run_knobs raises on any difference it checks (each served
batch against the plain version: exact; every served model within the
random-init gate of its float twin; finite losses).
"""

import torch

import chip_smoke
from test_torch_config2_phase import _small as small_config2
# run_dir is a fixture
from torch_parity import run_dir  # noqa: F401

torch.set_num_threads(2)


def _serving(batch, variant='base', f16=True, **knobs):
    cfg = chip_smoke.knob_serving_config(batch, variant, f16, **knobs)
    cfg.IMAGE_RESIZE_MODE = 'square'
    cfg.IMAGE_MIN_DIM = cfg.IMAGE_MAX_DIM = 64
    cfg.BRANCH_SIZE = 32
    cfg.BOTTLENECK_WIDTH = 16
    cfg.ORI_BINS_PER_DIM = 6
    cfg.update()
    return cfg


def _train(f16):
    cfg = chip_smoke.small_config(3)
    cfg.F16 = f16
    cfg.update()
    return cfg


def test_chip_smoke_knobs_phase_on_cpu(run_dir):
    out = chip_smoke.run_knobs(str(run_dir), 'cpu', 0, batch=2,
                               cfg_fn=_serving,
                               cfg2_fn=lambda: small_config2('resnet18'),
                               train_cfg_fn=_train)
    # the wrappers count only the kernels' launches: none on the CPU
    assert set(out['rows']) >= {'gemm_s8', 'conv_s8', 'stem_s8',
                                'gemm_s8_f32acc'}
    assert not any(out['rows'].values()) and not out['joins']
    assert out['warp_mold'] == 0 and out['ms'] == {}
    assert sorted(p.name for p in run_dir.iterdir()) == [
        'flagship_weights.msgpack', 'pruned_0.5.msgpack',
        'pruned_0.6.msgpack']
