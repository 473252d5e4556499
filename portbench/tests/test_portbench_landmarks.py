"""The landmark traffic kind (`train_landmarks.py`) on the CPU at a tiny
size: a sound run reads `correct`, the fp8 control and each fault do
not; `count_hrnet.py` against the paper's sizes and torch's flop counter
on the program's model; the landmark cell's per-layer readers on a run's
context."""

from __future__ import annotations

import types

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import common
import cells
import count_hrnet
import faults
import program
import program_landmarks

LANDMARKS = 'spec_hrnet_w32_landmarks.train_landmarks_f16_b32'


def tiny_landmarks():
    """The landmark cell at 64x64 crops (SPEED's focal length scaled with
    the crop), batches of 2, 8 frames, float32 (the CPU's bf16
    convolutions accumulate otherwise than the card's)."""
    cell = cells.load_cell(LANDMARKS)
    cell.config['config'].update(IMAGE_MIN_DIM=64, IMAGE_MAX_DIM=64,
                                 F16=False)
    cell.traffic.update(batch=2, frames=8, warmup_steps=1, crop=64,
                        focal=250.0)
    return cell


def test_landmark_cell_runs_and_is_correct():
    res = common.measure_cpu(tiny_landmarks())
    assert res['correct'] is True, res['checks']
    assert set(res['checks']) == {'loss_gap', 'stats_gap', 'update_gap'}
    assert set(res['metrics']) == {'train_imgs_per_s', 'setup_s'}
    assert res['attempted'] >= 4


@pytest.mark.parametrize('name', ['control', 'unchanged', 'half_batch'])
def test_landmark_control_and_faults_are_not_correct(name):
    cell = tiny_landmarks()
    res = common.measure_cpu(cell, fault=faults.fault(cell, name))
    assert res['correct'] is False, res['checks']


def test_count_hrnet_gives_the_published_sizes():
    # 28.5 M parameters, as the paper gives them; 7.65 G multiply-adds at
    # 256x192 (the paper's 7.1 GFLOPs counts fewer layers) and 91.7 G at
    # 768x768, with the 11-landmark head
    assert count_hrnet.params(11) == 28_535_915
    macs = [sum(l['macs'] for l in count_hrnet.layers(h, w))
            for h, w in ((256, 192), (768, 768))]
    assert macs[0] == pytest.approx(7.65e9, rel=1e-3)
    assert macs[1] == pytest.approx(91.7e9, rel=1e-3)
    assert count_hrnet.conv_outputs(768, 768) == pytest.approx(229e6,
                                                               rel=1e-2)
    assert count_hrnet.fusion_sums(768, 768) == pytest.approx(35.1e6,
                                                              rel=1e-2)


def test_count_hrnet_matches_the_flop_counter():
    cell = tiny_landmarks()
    keys = dict(cell.config['config'], IMAGES_PER_GPU=2, TRAIN_BN=True)
    cfg = program.make_config(keys)
    net = program_landmarks.build_model(cfg, 'cpu')
    for p in net.parameters():
        torch.nn.init.normal_(p, 0.0, 0.05)
    net.train()
    x = torch.randn(2, 3, 64, 64)
    with FlopCounterMode(display=False) as fc:
        out = net(x)
    assert fc.get_total_flops() == 2 * count_hrnet.train_flops(64, 64)[
        'forward']
    with FlopCounterMode(display=False) as fc:
        out = net(x)
        out['heatmaps'].sum().backward()
    assert fc.get_total_flops() == 2 * count_hrnet.train_flops(64, 64)[
        'matmul']


def test_landmark_readers_on_a_run_context():
    cell = cells.load_cell(LANDMARKS)
    assert {m['name'] for m in cell.per_layer} == {
        'landmarks.mfu', 'landmarks.conv_roofline', 'landmarks.fuse_fwd_ms',
        'landmarks.nonmatmul_ms', 'landmarks.idle_share',
        'landmarks.launches_per_step', 'landmarks.idle_backward_share'}
    # 8 kernels and a copy over 0-0.9 s; the backward's span 0.5-1.0 s
    trace = types.SimpleNamespace(
        window=(0.0, 1.0), window_s=1.0, kernel_busy_s=0.9,
        seconds_by_family=lambda: {'matmul': 0.5, 'batch_norm': 0.3},
        ops=[('kernel', 0.1 * i, 0.1 * i + 0.1) for i in range(8)]
        + [('Memcpy HtoD (Pinned -> Device)', 0.8, 0.9)],
        busy_intervals=lambda keep=None: [(0.0, 0.9)],
        host=[('ursonet.train.backward', 0.5, 1.0)])
    ctx = types.SimpleNamespace(
        kind='train_landmarks', height=768, width=768, batch=32,
        landmarks=11, steps=10, images=320, window_s=2.0, trace=trace,
        traced=4, fuse_s=0.04)
    got = {k: v['value'] for k, v in cells.read_per_layer(cell, ctx).items()}
    fwd = count_hrnet.train_flops(768, 768)
    assert got['landmarks.mfu'] == pytest.approx(
        100 * 3 * fwd['forward'] * 320 / 2.0 / 989e12)
    assert got['landmarks.conv_roofline'] == pytest.approx(
        100 * fwd['matmul'] * 128 / 989e12 / 0.5)
    assert got['landmarks.fuse_fwd_ms'] == pytest.approx(10.0)
    assert got['landmarks.nonmatmul_ms'] == pytest.approx(75.0)
    assert got['landmarks.idle_share'] == pytest.approx(10.0)
    assert got['landmarks.launches_per_step'] == pytest.approx(2.0)
    assert got['landmarks.idle_backward_share'] == pytest.approx(10.0)
    # a program without the fusion span gives no fusion metric
    ctx.fuse_s = 0.0
    assert 'landmarks.fuse_fwd_ms' not in cells.read_per_layer(cell, ctx)
    # the other kinds' readers leave the landmark cell alone
    ctx.kind = 'train'
    assert cells.read_per_layer(cell, ctx) == {}
