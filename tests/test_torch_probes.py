"""The kernel probes of the port (`ursonet_torch/probes/`): the plain
versions of `block_s8` and `mma_rate`, which the CPU runs and the card
holds the CUDA kernels against, against the TPU kernels they port and
against numpy, and the three probe entry points at tiny sizes on the CPU.

The Pallas kernels run in interpret mode: `pl.pallas_call` is patched for
the test so that the probes in `tools/` trace their kernels with
`interpret=True` (their own calls ask for the TPU).

Tolerances:
  * `block_s8_torch` against `xla_block`: the TPU probe's own gate is 1
    int8 LSB; on these inputs the two agree in every element, so the test
    holds them exact. Against the Pallas `fused_block` in interpret mode
    (its DMAs and semaphores are interpreted): 1 LSB, in at most 0.2% of
    the elements (0.06% measured): the interpreter rounds acc * a and
    + b apart, the plain version and XLA's compiled epilogue in one FMA.
  * `mma_rate_torch` for s8 and s4: exact, int32 wrap included. bf16:
    1e-5 of the output's largest magnitude against a float64 product of
    the same bf16 values (f32 accumulation in another order).
  * The int4 Pallas loop cannot be interpreted with int4 operands: XLA's
    CPU backend refuses the int4 dot ("does not support custom element
    sizes"), so the loop is run with the operands left in int8, which
    holds the same int4-range values.
"""

import importlib.util
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from ursonet_torch.ops import int8_cuda as ic
from ursonet_torch.probes import fused_block as fb
from ursonet_torch.probes import int4_mma, int8_mma
from ursonet_torch.probes import mma_rate as mr

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _probe(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, 'tools', f'{name}.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def interpreted(monkeypatch):
    """Patch pl.pallas_call to interpret mode; returns the list of
    (kernel, keyword arguments) of every call traced meanwhile."""
    real = pl.pallas_call
    caught = []

    def patched(kernel, **kw):
        kw['interpret'] = True
        caught.append((kernel, kw))
        return real(kernel, **kw)
    monkeypatch.setattr(pl, 'pallas_call', patched)
    caught.append(real)
    return caught


# --------------------------------------------------------------------------
# kernel 3: tools/probe_fused_block.py::_fused_kernel


def _block_case(seed, b, h, w):
    """fb.operands on the CPU, and the same values as xla_block takes
    them (HWIO kernels, the epilogue rows apart)."""
    x, w1, w2, w3, ab = fb.operands(b, h, w, seed, 'cpu')
    a = ab.numpy()
    jax_args = (jnp.asarray(x.numpy()),
                jnp.asarray(w1.numpy().reshape(1, 1, fb.CIN, fb.CMID)),
                jnp.asarray(w2.numpy().reshape(3, 3, fb.CMID, fb.CMID)),
                jnp.asarray(w3.numpy().reshape(1, 1, fb.CMID, fb.CIN)),
                a[0, :fb.CMID], a[1, :fb.CMID], a[2, :fb.CMID],
                a[3, :fb.CMID], a[4], a[5], a[6])
    return (x, w1, w2, w3, ab), jax_args


@pytest.mark.parametrize('b,h,w', [(2, 16, 8), (1, 5, 7), (1, 32, 24)])
def test_block_plain_matches_xla_block(b, h, w):
    probe = _probe('probe_fused_block')
    ops, jax_args = _block_case(b * h + w, b, h, w)
    want = np.asarray(probe.xla_block(*jax_args))
    before = fb.launches['block_s8']
    got = fb.block_s8(*ops).numpy()           # CPU tensors: the plain version
    assert fb.launches['block_s8'] == before
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    print(f"block_s8_torch vs xla_block {b}x{h}x{w}: max {diff.max()} LSB, "
          f"differing fraction {(diff > 0).mean():.2e}")
    assert diff.max() <= 1                     # the TPU probe's gate
    np.testing.assert_array_equal(got, want)
    assert 0 < got.max() <= 127 and got.min() >= 0 and (got > 0).mean() > 0.2


def test_block_plain_pads_m1_with_zeros():
    """The 3x3 is SAME over m1: outside the image m1 is 0, not
    requant(b1). With x = 0, m1 = requant(b1) inside; at a corner the 3x3
    sees 4 such pixels, in the middle 9."""
    x, w1, w2, w3, ab = fb.operands(1, 4, 4, 0, 'cpu')
    x.zero_()
    ab[1, :fb.CMID] = 50.0                      # m1 = 50 inside the image
    ab[2, :fb.CMID] = 1e-3
    ab[3, :fb.CMID] = 0.0
    w2[:] = 1
    m2_mid = round(9 * fb.CMID * 50 * 1e-3)     # 29
    m2_corner = round(4 * fb.CMID * 50 * 1e-3)  # 13
    ab[4], ab[5] = 1.0, 0.0
    w3.zero_()
    w3[0] = 1                                   # out = m2[..., 0]
    out = fb.block_s8_torch(x, w1, w2, w3, ab)
    assert int(out[0, 1, 1, 0]) == m2_mid and int(out[0, 0, 0, 0]) == m2_corner


@pytest.mark.parametrize('strip', [16, 32])
def test_block_plain_matches_pallas_fused_block(interpreted, strip):
    probe = _probe('probe_fused_block')
    ops, _ = _block_case(strip, 2, 32, 8)
    want = np.asarray(probe.fused_block(
        *(jnp.asarray(t.numpy()) for t in ops), strip=strip))
    assert len(interpreted) == 2                # the patched call was traced
    got = fb.block_s8_torch(*ops).numpy()
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    print(f"block_s8_torch vs fused_block strip {strip}: max {diff.max()} "
          f"LSB, differing fraction {(diff > 0).mean():.2e}")
    assert diff.max() <= 1 and (diff > 0).mean() <= 2e-3


def test_block_bytes_and_operations():
    nbytes, nops = fb.block_bytes_ops(128, 128, 160)
    px = 128 * 128 * 160
    assert nops == 2 * px * 69632 and abs(nops - 3.65e11) < 0.01e11
    assert 2 * px * 256 <= nbytes <= 2 * px * 256 + 100_000


def test_block_wrapper_refuses_other_devices():
    ops = fb.operands(1, 4, 4, 0, 'cpu')
    with pytest.raises(ValueError):
        fb.block_s8(ops[0].to('meta'), *ops[1:])
    x, w1, w2, w3, ab = ops
    ab2 = ab.clone()
    ab2[6, 3] = 0.2
    with pytest.raises(ValueError):
        fb.block_s8_unfused(x, w1, w2, w3, ab2)
    np.testing.assert_array_equal(fb.block_s8_unfused(*ops).numpy(),
                                  fb.block_s8_torch(*ops).numpy())


# --------------------------------------------------------------------------
# kernels 7 and 8: the loops of tools/probe_int8_mxu.py, probe_int4_mxu.py


def _wrap32(a):
    return ((a + 2 ** 31) % 2 ** 32 - 2 ** 31).astype(np.int32)


@pytest.mark.parametrize('kind', ['s8', 's4'])
@pytest.mark.parametrize('m,n,k,iters', [(128, 128, 128, 3), (64, 32, 512, 0),
                                         (32, 64, 2048, 4096)])
def test_mma_rate_plain_matches_numpy_integers(kind, m, n, k, iters):
    """iters * (A @ B) with int32 wrap; the last case wraps for s8. s4
    keeps the low 4 bits of each operand (-8..7)."""
    rng = np.random.RandomState(k)
    lim = 127 if kind == 's8' or iters == 0 else 7
    a = rng.randint(-lim, lim + 1, (m, k)).astype(np.int8)
    b = rng.randint(-lim, lim + 1, (k, n)).astype(np.int8)
    if iters == 4096 and kind == 's8':
        a[:] = 127
        b[:] = 127
    a4, b4 = a.astype(np.int64), b.astype(np.int64)
    if kind == 's4':
        a4, b4 = (a4 + 8) % 16 - 8, (b4 + 8) % 16 - 8
    exact = (a4 @ b4) * iters
    want = _wrap32(exact)
    got = mr.mma_rate(torch.from_numpy(a), ic.kernel_layout(b), iters, kind)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    if iters == 4096 and kind == 's8':
        assert (exact != want).any()            # it did wrap
    every = mr.mma_rate(torch.from_numpy(a), ic.kernel_layout(b), iters, kind,
                        all_replicas=True)
    assert every.shape == (1, m, n)


def test_mma_rate_plain_matches_numpy_bf16():
    a, b = mr.operands('bf16', 128, 64, 256, 3, 'cpu')
    got = mr.mma_rate_torch(a, b, 5, 'bf16')
    want = 5.0 * (a.double().numpy() @ b.double().numpy())
    assert got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()
    with pytest.raises(ValueError):
        mr.mma_rate_torch(a, b, 1, 'fp8')


def _loop_output(interpreted, a, b):
    """Run the Pallas loop kernel that the probe traced last on a and b."""
    real, (kernel, kw) = interpreted[0], interpreted[-1]
    return np.asarray(real(kernel, **kw)(jnp.asarray(a), jnp.asarray(b)))


def test_mma_rate_plain_matches_pallas_int8_loop(interpreted):
    probe = _probe('probe_int8_mxu')
    probe.mxu_probe(128, 128, 128, 3, jnp.int8, jnp.int32)
    rng = np.random.RandomState(0)
    a = rng.randint(-127, 128, (128, 128)).astype(np.int8)
    b = rng.randint(-127, 128, (128, 128)).astype(np.int8)
    want = _loop_output(interpreted, a, b)
    got = mr.mma_rate_torch(torch.from_numpy(a), ic.kernel_layout(b), 3, 's8')
    np.testing.assert_array_equal(got.numpy(), want)


def test_mma_rate_plain_matches_pallas_bf16_loop(interpreted):
    probe = _probe('probe_int8_mxu')
    probe.mxu_probe(128, 128, 128, 3, jnp.bfloat16, jnp.float32)
    a, b = mr.operands('bf16', 128, 128, 128, 1, 'cpu')
    want = _loop_output(interpreted, jnp.asarray(a.float().numpy(),
                                                 jnp.bfloat16),
                        jnp.asarray(b.float().numpy(), jnp.bfloat16))
    got = mr.mma_rate_torch(a, b, 3, 'bf16').numpy()
    assert want.dtype == np.float32
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_mma_rate_plain_matches_pallas_int4_loop(interpreted):
    """The int4 probe's loop on int4-range operands, left in int8 (module
    docstring): the values the s4 kind computes."""
    probe = _probe('probe_int4_mxu')
    probe.pallas_vmem_loop(128, 128, 128, 3, jnp.int8, reps=1)
    rng = np.random.RandomState(4)
    a = rng.randint(-7, 8, (128, 128)).astype(np.int8)
    b = rng.randint(-7, 8, (128, 128)).astype(np.int8)
    want = _loop_output(interpreted, a, b)
    got = mr.mma_rate_torch(torch.from_numpy(a), ic.kernel_layout(b), 3, 's4')
    np.testing.assert_array_equal(got.numpy(), want)


def test_mma_rate_tiles_and_replicas():
    assert mr.tile_for('s8', 512, 'mma_sync') == (128, 128)
    assert mr.tile_for('s8', 1024, 'mma_sync') == (64, 128)
    assert mr.tile_for('bf16', 512, 'mma_sync') == (64, 128)
    assert mr.tile_for('bf16', 1024, 'mma_sync') == (32, 64)
    assert mr.tile_for('s4', 1024, 'mma_sync') == (128, 128)
    assert mr.tile_for('s8', 512) == (128, 256)          # wgmma, the default
    for route in mr.ROUTES:
        with pytest.raises(ValueError):
            mr.tile_for('bf16', 2048, route)
    # a 256x256 output is four 128x128 tiles: 33 replicas fill 132 SMs
    assert mr.default_replicas(4, 132) == 33
    assert mr.default_replicas(64, 132) == 33
    assert mr.default_replicas(132, 132) == 1
    for kind in mr.KINDS:
        a, b = mr.operands(kind, 32, 64, 128, 0, 'cpu')
        assert a.shape == (32, 128) and b.shape == (128, 64)
        assert a.dtype == b.dtype == mr.IN_DTYPES[kind]
        assert b.t().is_contiguous()
        assert mr.mma_rate(a, b, 2, kind).dtype == mr.OUT_DTYPES[kind]
    a, b = mr.operands('s4', 32, 64, 128, 0, 'cpu')
    assert int(a.abs().max()) == 7
    with pytest.raises(ValueError):
        mr.mma_rate(a.to('meta'), b.to('meta'), 1, 's8')


# --------------------------------------------------------------------------
# the entry points, at tiny sizes on the CPU


def _json_lines(capsys):
    return [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith('{')]


def test_fused_block_entry_point(capsys):
    rows = fb.main(['--device', 'cpu', '--batch', '2', '--h', '9', '--w', '17',
                    '--reps', '1', '--check-batch', '1'])
    assert rows == _json_lines(capsys) and len(rows) == 2
    assert rows[0]['probe'] == 'block_s8' and rows[0]['device'] == 'cpu'
    assert rows[0]['max_lsb_diff_vs_plain'] == 0
    assert rows[0]['max_lsb_diff_vs_unfused'] == 0
    assert rows[0]['shape'] == [2, 9, 17, 256, 64]
    assert rows[1]['probe'].startswith('unfused') and rows[1]['ms'] > 0


def test_int8_mma_entry_point(capsys):
    rows = int8_mma.main(['--device', 'cpu', '--iters', '2', '--reps', '1',
                          '--matmul-size', '64', '--max-dim', '256'])
    assert rows == _json_lines(capsys)
    assert [r['probe'] for r in rows] == ['torch-matmul'] * 2 \
        + ['mma-smem-loop'] * 6
    loops = {(r['variant'], r['route']): r for r in rows[2:]}
    assert len(loops) == 6
    for route in mr.ROUTES:
        assert loops['int8->bf16', route]['error'].startswith('unsupported')
        for name in ('bf16->f32', 'int8->int32'):
            row = loops[name, route]
            assert row['mnk'] == [256, 256, 256]
            assert row['iters'] == 2 and row['tops'] > 0
            assert 'ms_half_iters' in row and 'linear' in row
            assert row['sm_clock_mhz'] is None          # no card
    assert loops['int8->int32', 'wgmma']['tile'] == [128, 256]
    assert loops['int8->int32', 'mma_sync']['tile'] == [128, 128]


def test_int4_mma_entry_point(capsys):
    rows = int4_mma.main(['--device', 'cpu', '--iters', '2', '--reps', '1',
                          '--matmul-size', '64', '--max-dim', '512',
                          '--conv-batch', '1', '--conv-channels', '32'])
    assert rows == _json_lines(capsys)
    by = {(r['probe'], r['variant']): r for r in rows}
    for probe in ('torch-dot', 'conv-C4-3x3'):
        assert by[(probe, 'int4')]['error'] == int4_mma.NO_INT4
        assert by[(probe, 'w4a8')]['error'] == int4_mma.NO_INT4
        assert by[(probe, 'int8')]['tops'] > 0
    assert by[('mma-smem-loop', 'int4')]['mnk'] == [512, 512, 512]
    assert by[('mma-smem-loop', 'int8')]['replicas'] == 1
    routes = {(r['variant'], r['route']) for r in rows
              if r['probe'] == 'mma-smem-loop'}
    assert routes == {(v, r) for v in ('int4', 'int8') for r in mr.ROUTES}
