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
from ursonet_torch import presets
from ursonet_torch.checkpoint.quant_store import load_quantized
from ursonet_torch.data.loader import make_device_preprocess
from ursonet_torch.engine import ServingEngine
from ursonet_torch.models.quant import QuantizedModel
from ursonet_torch.models.ursonet import build_model
from ursonet_torch.ops import cuda_build, int8_cuda
from ursonet_torch.train.optim import make_optimizer
from ursonet_torch.train.step import make_eval_step, make_train_step
from torch_parity import small_configs

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'optax', 'ursonet_tpu', 'pandas', 'PIL',
             'cv2', 'msgpack', 'tools', 'h5py', 'matplotlib', 'orbax',
             'tensorstore', 'zstandard', 'zstd')


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


def test_the_checks_cover_the_data_and_engine_modules():
    """The engine's and the command line's modules are among those the
    two checks above import and parse."""
    names = set(_module_names())
    for m in ('ursonet_torch.data.png', 'ursonet_torch.data.dataset',
              'ursonet_torch.data.urso', 'ursonet_torch.data.synthetic',
              'ursonet_torch.data.loader', 'ursonet_torch.checkpoint.msgpack',
              'ursonet_torch.checkpoint.store', 'ursonet_torch.utils.memory',
              'ursonet_torch.engine', 'ursonet_torch.checkpoint.hdf5',
              'ursonet_torch.checkpoint.h5_import', 'ursonet_torch.ops.gmm',
              'ursonet_torch.ops.viz', 'ursonet_torch.evaluate',
              'ursonet_torch.pose_estimator', 'ursonet_torch.data.jpeg',
              'ursonet_torch.data.speed', 'ursonet_torch.submission',
              'ursonet_torch.split_dataset', 'ursonet_torch.checkpoint.zstd',
              'ursonet_torch.checkpoint.ocdbt', 'ursonet_torch.checkpoint.zarr',
              'ursonet_torch.checkpoint.orbax_store',
              'ursonet_torch.parallel', 'ursonet_torch.parallel.mesh',
              'ursonet_torch.parallel.sharding',
              'ursonet_torch.parallel.multihost'):
        assert m in names, m
    assert ROOT / 'ursonet_torch' / 'data' / 'png.py' in _port_sources()


def test_sources_import_no_jax():
    # and the worker the parallel tests spawn (its processes run no JAX)
    for path in _port_sources() + [ROOT / 'tests' /
                                   'torch_parallel_worker.py']:
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


def test_serving_entry_points_refuse_cpu_fallback(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    _, cfg = small_configs()
    with pytest.raises(RuntimeError, match='CUDA'):
        ServingEngine(cfg)
    model = build_model(cfg, device='cpu')
    with pytest.raises(RuntimeError, match='CUDA'):
        ServingEngine(cfg, model=model)
    flat = {'conv1': (np.zeros((7, 7, 3, 64), np.float32),
                      np.zeros(64, np.float32))}
    with pytest.raises(RuntimeError, match='CUDA'):
        QuantizedModel(cfg, flat)
    with pytest.raises(RuntimeError, match='CUDA'):
        load_quantized(str(ROOT / 'tests' / 'data' / 'gate_int8.msgpack'),
                       presets.serving_config())
    # the kernels' wrappers: plain versions for CPU tensors only
    a = torch.zeros(4, 8, dtype=torch.int8)
    b = int8_cuda.kernel_layout(np.zeros((8, 3), np.int8))
    assert int8_cuda.gemm_s8(a, b).dtype == torch.int32
    with pytest.raises(ValueError):
        int8_cuda.gemm_s8(a.to('meta'), b.to('meta'))


def test_build_helper_names_every_source():
    names = sorted(p.stem for p in (ROOT / 'ursonet_torch' / 'csrc')
                   .glob('*.cu'))
    assert sorted(cuda_build.SOURCES) == names
    paths = {n: cuda_build.library_path(n) for n in names}
    assert len(set(paths.values())) == len(names)
    for n, p in paths.items():
        assert p.parent == cuda_build.BUILD_DIR and p.name.startswith(n)
    assert '-fmad=false' in cuda_build.NVCC_FLAGS
    assert 'arch=compute_90a,code=sm_90a' in cuda_build.NVCC_FLAGS


def test_chip_smoke_serving_cases_follow_the_flagship():
    """The kernel checks and timings cover the serving path's shapes:
    per stage the 3x3 conv and four 1x1 kinds, the stem, the bottleneck
    conv and the three head denses."""
    convs = dict(chip_smoke.conv_cases(8))
    assert len(convs) == 6
    assert convs['stem 7x7/2'][3:6] == (3, 7, 7)
    assert convs['bottleneck 3x3/2'][1:4] == (16, 20, 2048)
    gemms = dict(chip_smoke.gemm_cases(128))
    assert len(gemms) == 19
    assert gemms['ori_final'] == (128, 1024, 13824)
    assert gemms['C5 branch1'] == (128, 1024, 2048)
    cfg = presets.serving_config()
    assert cfg.head_input_features() == gemms['loc_dense_0'][1]
    args = chip_smoke.epilogue_args(torch.device('cpu'),
                                    np.random.RandomState(0), (4, 6), 64,
                                    'join')
    assert args['alpha'].shape == (6,) and args['res'].shape == (4, 6)
    small = chip_smoke.small_serving_config()
    assert small.BATCH_SIZE == 2 and tuple(small.IMAGE_SHAPE[:2]) == (64, 64)
    assert small.REGRESS_LOC and not small.REGRESS_ORI


def test_kernel_modules_import_and_run_on_cpu_without_building():
    """Importing the modules that hold kernels, and calling their
    wrappers on CPU tensors, starts no compiler and loads no library."""
    code = (
        "import subprocess, sys, json\n"
        "def refuse(*a, **k):\n"
        "    raise AssertionError('a process was started')\n"
        "subprocess.Popen = subprocess.run = refuse\n"
        "import numpy as np, torch\n"
        "from ursonet_torch.ops import actq_cuda, cuda_build, int8_cuda, "
        "warp_cuda\n"
        "from ursonet_torch.probes import fused_block, int4_mma, int8_mma, "
        "mma_rate\n"
        "x = torch.zeros(1, 4, 6, 12, dtype=torch.uint8)\n"
        "w = int8_cuda.kernel_layout(np.ones((4, 4, 12, 64), np.int8))\n"
        "y = int8_cuda.stem_s8(x, w, torch.ones(64), torch.zeros(64))\n"
        "ops = fused_block.operands(1, 3, 3, 0, 'cpu')\n"
        "z = fused_block.block_s8(*ops)\n"
        "a, b = mma_rate.operands('s4', 32, 64, 64, 0, 'cpu')\n"
        "r = mma_rate.mma_rate(a, b, 2, 's4')\n"
        "q, sc = actq_cuda.quant_s8(torch.ones(2, 3, 4, 4), 'x')\n"
        "qg, al = actq_cuda.quant_s8(torch.ones(2, 5, 4, 4), 'g', sc, "
        "alpha_len=27)\n"
        "dw = actq_cuda.wgrad_s8(q, qg, (3, 3), 1, ((1, 1), (1, 1)), al)\n"
        "print(json.dumps([list(y.shape), list(z.shape), list(r.shape), "
        "len(cuda_build._libs), cuda_build.BUILD_DIR.exists(), "
        "sum(int8_cuda.launches.values()) + "
        "sum(fused_block.launches.values()) + "
        "sum(mma_rate.launches.values()) + "
        "sum(actq_cuda.launches.values()), list(dw.shape)]))\n")
    existed = cuda_build.BUILD_DIR.exists()
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == [
        [1, 2, 3, 64], [1, 3, 3, 256], [32, 64], 0, existed, 0,
        [5, 3, 3, 3]]


@pytest.mark.parametrize('probe', ['fused_block', 'int8_mma', 'int4_mma',
                                   'stem', 'actq_wgrad8'])
def test_probe_entry_points_refuse_cpu_fallback(monkeypatch, probe):
    import importlib
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    mod = importlib.import_module(f'ursonet_torch.probes.{probe}')
    with pytest.raises(RuntimeError, match='CUDA'):
        mod.main([])


def test_serving_variants_set_the_s2d_knobs():
    knobs = {v: (presets.serving_config(variant=v).QUANT_STEM_S2D,
                 presets.serving_config(variant=v).QUANT_HOST_S2D)
             for v in presets.SERVING_VARIANTS}
    assert knobs == {'base': (False, False), 's2d': (True, False),
                     'host_s2d': (True, True)}
    for v in presets.SERVING_VARIANTS:
        small = chip_smoke.small_serving_config(v)
        assert small.QUANT_STEM_S2D == knobs[v][0]
    args = chip_smoke.stem_args(torch.device('cpu'), np.random.RandomState(0),
                                'shift128')
    assert args['mean'].shape == (12,) and args['alpha'].shape == (64,)
    x, w = chip_smoke.stem_operands('cpu', np.random.RandomState(0), 1, 6, 4)
    assert int8_cuda.stem_s8(x, w, **args).shape == (1, 3, 2, 64)
