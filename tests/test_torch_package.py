"""Package boundary of the PyTorch port: it imports nothing of JAX or of
the JAX package (nor the image and table libraries the card's machine
lacks), its entry points refuse to fall back from CUDA to the CPU, and
chip_smoke.py's main path runs at a small size on the CPU."""

import ast
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import chip_smoke
from ursonet_torch.data.loader import make_device_preprocess
from ursonet_torch.models.ursonet import build_model
from ursonet_torch.train.optim import make_optimizer
from ursonet_torch.train.step import make_eval_step, make_train_step
from torch_parity import small_configs

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'optax', 'ursonet_tpu', 'pandas', 'PIL',
             'cv2')


def _port_sources():
    return sorted((ROOT / 'ursonet_torch').rglob('*.py')) + \
        [ROOT / 'chip_smoke.py', ROOT / 'profile_step.py']


def _module_names():
    names = []
    for path in sorted((ROOT / 'ursonet_torch').rglob('*.py')):
        rel = path.relative_to(ROOT).with_suffix('')
        parts = list(rel.parts)
        if parts[-1] == '__init__':
            parts = parts[:-1]
        names.append('.'.join(parts))
    return names


def test_import_pulls_in_no_jax():
    code = (
        "import sys, importlib, json\n"
        f"for m in {_module_names()!r} + ['chip_smoke', 'profile_step']:\n"
        "    importlib.import_module(m)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print(json.dumps(bad))\n")
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_sources_import_no_jax():
    for path in _port_sources():
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                roots = [a.name.split('.')[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                roots = [(node.module or '').split('.')[0]]
            else:
                continue
            for r in roots:
                assert r not in FORBIDDEN, f"{path}: imports {r}"


def test_entry_points_refuse_cpu_fallback(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    _, cfg = small_configs()
    with pytest.raises(RuntimeError, match='CUDA'):
        build_model(cfg)
    with pytest.raises(RuntimeError, match='CUDA'):
        make_device_preprocess(cfg)
    model = build_model(cfg, device='cpu')
    with pytest.raises(RuntimeError, match='CUDA'):
        make_train_step(model, cfg, make_optimizer(cfg))
    with pytest.raises(RuntimeError, match='CUDA'):
        make_eval_step(model, cfg)


def test_step_refuses_model_on_other_device():
    _, cfg = small_configs()
    model = build_model(cfg, device='cpu')
    with torch.device('meta'):
        other = torch.nn.Linear(2, 2)
    model.add_module('stray', other)
    with pytest.raises(ValueError):
        make_train_step(model, cfg, make_optimizer(cfg), device='cpu')


def test_chip_smoke_without_card_fails_and_prints_nothing(monkeypatch,
                                                          capsys):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    assert chip_smoke.main([]) != 0
    assert '"ok"' not in capsys.readouterr().out


def test_chip_smoke_main_path_on_cpu():
    cfg = chip_smoke.small_config()
    res = chip_smoke.run_main_path(cfg, 'cpu', seed=0, steps=3)
    chip_smoke.check_main_path(res)
    for m in res['train'] + [res['val']]:
        assert all(np.isfinite(v) for v in m.values())
    assert set(res['train'][0]) == {'loc_loss', 'ori_loss', 'loss', 'l2_reg'}


def test_chip_smoke_raw_batch_is_well_formed():
    cfg = chip_smoke.flagship_config()
    assert cfg.BATCH_SIZE == 32 and tuple(cfg.IMAGE_SHAPE[:2]) == (512, 640)
    assert cfg.BACKBONE == 'resnet50' and cfg.ORI_BINS_PER_DIM == 24
    small = chip_smoke.small_config()
    raw = chip_smoke.make_raw_batch(small, seed=1)
    assert raw['images_u8'].shape == (2, 64, 64, 3)
    assert raw['images_u8'].dtype == np.uint8
    np.testing.assert_allclose(np.linalg.norm(raw['quaternion'], axis=1), 1,
                               rtol=1e-6)
    assert (raw['quaternion'][:, 3] >= 0).all()
    assert raw['image_meta'].shape == (2, small.IMAGE_META_SIZE)
    Ms = chip_smoke.homographies(4, chip_smoke.net_intrinsics(cfg),
                                 np.random.RandomState(0))
    assert Ms.shape == (4, 3, 3) and Ms.dtype == np.float32
