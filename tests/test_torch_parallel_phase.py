"""chip_smoke.py's phase 8f (`run_parallel`) on the CPU at a small size
(benchmark_config(3) at 64x64, chip_smoke.small_config): the world of
one (gloo here, NCCL on the card) equal to the step without a mesh bit
for bit and serving under its mesh equal to unsharded serving, then the
2 x 2 world of four processes against the world of one, its rank-0
state resumed by a fresh world bit for bit, int8 served over its 2 data
rows. The phase raises on any difference; on the card it runs at full
width."""

import torch

import chip_smoke as c

torch.set_num_threads(1)


def test_parallel_phase_runs_on_the_cpu(tmp_path):
    res = c.run_parallel(str(tmp_path), 'cpu', 0, cfg=c.small_config(),
                         serve=8)
    # the plain versions run on the CPU: no kernel launches to count
    assert set(res['rows']) >= {'warp_mold', 'gemm_s8_f32acc',
                                'conv_s8_f32acc'}
    assert res['fused_err'] == 0.0
