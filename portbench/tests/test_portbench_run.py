"""Whole runs on the CPU at a tiny size with the program's plain paths:
the result's keys, the refusal of device metrics and of a run without a
card, the comparison with the plain reference, and the faults it has to
catch: an answer altered where it is produced, half of a batch left out,
a train step that leaves the state unchanged."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest
import torch

import common
import faults
import run

KEYS = ['correct', 'attempted', 'failed', 'metrics', 'setup', 'checks']


def test_serve_cell_runs_and_is_correct():
    res = common.measure_cpu(common.tiny_serve(), plain=True)
    assert list(res) == KEYS                     # the checks come last
    assert res['correct'] is True
    assert res['attempted'] >= 1 and res['failed'] == 0
    assert set(res['metrics']) == {'serve_imgs_per_s', 'setup_s'}
    assert 'device' not in res                   # no device on the CPU
    gap = res['checks']['answer_gap']
    assert gap['value'] <= gap['limit']


def test_keypoint_serve_cell_is_correct():
    res = common.measure_cpu(common.tiny_serve(common.SERVE_KP), plain=True)
    assert res['correct'] is True


def test_cpu_run_refuses_device_metrics():
    with pytest.raises(RuntimeError, match='device metrics'):
        run.measure(common.tiny_serve(), common.SEED, 0.5, True, 'cpu')


@pytest.mark.parametrize('name', ['alter_answer', 'drop_half'])
def test_serve_fault_is_not_correct(name):
    cell = common.tiny_serve()
    res = common.measure_cpu(cell, plain=True, fault=faults.fault(cell, name))
    assert res['correct'] is False


def test_serve_control_fails_its_limit():
    cell = common.tiny_serve()
    res = common.measure_cpu(cell, plain=True,
                             fault=faults.fault(cell, 'control'))
    c = res['checks']['answer_gap']
    assert c['value'] > c['limit']
    assert res['correct'] is False


def test_train_cell_runs_and_is_correct():
    res = common.measure_cpu(common.tiny_train())
    assert list(res) == KEYS
    assert res['correct'] is True, res['checks']
    assert set(res['checks']) == {'loss_gap', 'update_gap'}


@pytest.mark.parametrize('name', ['unchanged', 'half_batch'])
def test_train_fault_is_not_correct(name):
    cell = common.tiny_train()
    res = common.measure_cpu(cell, fault=faults.fault(cell, name))
    assert res['correct'] is False, res['checks']


def test_train_control_fails_a_limit():
    cell = common.tiny_train()
    res = common.measure_cpu(cell, fault=faults.fault(cell, 'control'))
    checks = res['checks']
    assert any(v['value'] > v['limit'] for v in checks.values()), checks
    assert res['correct'] is False


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES='')
    proc = subprocess.run(
        [sys.executable, str(common.PORTBENCH / 'run.py'), '--workload',
         common.SERVE, '--seed', '1', '--seconds', '1', '--trace', '0'],
        cwd=common.REPO, env=env, capture_output=True, text=True,
        timeout=300)
    if torch.cuda.is_available():
        pytest.skip('this machine has a card')
    assert proc.returncode == 2
    assert proc.stdout.strip() == ''


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, 'ursonet_tpu_like', sys)
    assert 'ursonet_tpu' not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, 'flax.core', sys)
    assert run.forbidden_modules() == ['flax']


def test_a_run_loads_no_jax():
    code = ("import sys; sys.path.insert(0, %r); import common, run; "
            "common.measure_cpu(common.tiny_serve(), plain=True); "
            "print(run.forbidden_modules())" % str(common.HERE))
    proc = subprocess.run([sys.executable, '-c', code], cwd=common.REPO,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1] == '[]'


@pytest.mark.cuda
def test_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    proc = subprocess.run(
        [sys.executable, 'portbench/run.py', '--workload', common.SERVE,
         '--seed', str(common.SEED), '--seconds', '2', '--trace', '0'],
        cwd=common.REPO, capture_output=True, text=True, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-4000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res['correct'] is True
    assert list(res)[-1] == 'checks'
    assert res['device']['platform'] == 'gpu'
