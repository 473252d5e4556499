"""TRAIN_ACT_Q8 in the port (`ursonet_torch/models/actq.py`,
`ops/actq_cuda.py`) against the JAX package's `models/actq.py`, on the
CPU (the kernels' plain versions), inputs made with numpy from seeds.

Tolerances and why:
  * the port's ConvQ8 against its own Conv2d: forward, dx and the bias
    gradient bit for bit (the same aten calls), in f32 and bf16;
  * q and scale against `_quantize_per_sample`, the g-quantize against
    `_q8w8_bwd`'s formulas, the int32 wgrad against `_wgrad_conv(...,
    preferred=int32)`: bit for bit (the same rounding rules);
  * against JAX's ConvQ8 in f32: forward and dx within 1e-5 relative L2
    (XLA and PyTorch sum the conv in other orders); dw of 'wgrad8' within
    1e-6 (the int8 sums are exact, so only the forward's input differs:
    not at all here), of True within 1e-5;
  * whole models at 64x64: the loss equal to the plain model's bit for
    bit (the JAX package's own test holds it within 1e-6 of its plain
    model) and within 1e-5 relative of JAX's (the forwards sum in other
    orders: tests/test_torch_train.py's metric bound), each gradient
    within 2e-3 relative L2 of JAX's act_q8 gradients (an activation that
    differs by a summation order in the last bit may round to the next
    int8 level, which moves dw by one step of 1/127 of its sample's max);
  * train steps against JAX's step: 1e-3 in update units
    (tests/test_torch_train.py), the metrics 1e-5 (f32); F16: the losses
    3e-2 and the update 0.35 in update units (tests/test_torch_bf16_train
    .py's bounds for the bf16 step);
  * REMAT='narrow' and a gloo world of 2 (data-parallel) against one
    process: gradients bit for bit, and the JAX package's DP x TP bounds
    (loss 1e-5 relative, parameters rtol 2e-4 / atol 2e-5).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import flax.linen as nn
import jax
import jax.numpy as jnp

from ursonet_tpu.config import Config as JaxConfig
from ursonet_tpu.models import actq as jactq
from ursonet_tpu.models.ursonet import build_model as jax_build_model
from ursonet_tpu.train import state as jstate
from ursonet_tpu.train.optim import make_optimizer as jax_make_optimizer
from ursonet_tpu.train.step import make_train_step as jax_make_train_step
from ursonet_torch.checkpoint.convert import params_to_jax_layout
from ursonet_torch.config import Config
from ursonet_torch.models.actq import ConvQ8
from ursonet_torch.models.resnet import Conv2d
from ursonet_torch.models.ursonet import build_model
from ursonet_torch.ops import actq_cuda, int8_cuda
from ursonet_torch.train.optim import make_optimizer
from ursonet_torch.train.step import make_train_step
from ursonet_torch.utils import memory
import torch_parallel_worker as W

torch.set_num_threads(2)

BF16 = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}

# (N, H, W, Ci, Co, k, stride, JAX padding): the four geometries of the
# JAX package's tests/test_model.py, the s2d stem's (12 channels, 4x4/1,
# pads (2,1)) and the int32 guard's shape (N * H * W > 133,144)
GEOMS = {
    'k3s1_same': (2, 16, 16, 8, 12, 3, 1, 'SAME'),
    'k3s2_same': (2, 16, 16, 8, 12, 3, 2, 'SAME'),
    'k7s2_stem': (2, 16, 16, 8, 12, 7, 2, ((3, 3), (3, 3))),
    'k1s1_valid': (2, 16, 16, 8, 12, 1, 1, 'VALID'),
    'k4s1_s2d': (2, 8, 8, 12, 12, 4, 1, ((2, 1), (2, 1))),
    'guard': (8, 144, 144, 2, 4, 3, 1, 'SAME'),
}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _pads(geom):
    n, h, w, ci, co, k, s, pad = geom
    return jactq._resolve_pad(pad, (k, k), (s, s), (h, w))


def port_conv(geom, mode, bias, weight):
    """The port's ConvQ8 (or Conv2d for mode False) for a JAX geometry:
    symmetric pads inside the conv, others written out before it (as the
    port's backbone pads the s2d stem). Returns (module, pad fn)."""
    n, h, w, ci, co, k, s, pad = geom
    (pt, pb), (pl, pr) = _pads(geom)
    sym = pt == pb and pl == pr
    kw = dict(padding=(pt, pl) if sym else 0, bias=bias)
    m = ConvQ8(ci, co, k, s, mode=mode, **kw) if mode \
        else Conv2d(ci, co, k, s, **kw)
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(weight.transpose(3, 2, 0, 1)))
        if bias:
            m.bias.copy_(torch.arange(co, dtype=torch.float32) * 0.1)
    return m, (lambda x: x) if sym else (lambda x: F.pad(x, (pl, pr, pt, pb)))


def inputs(geom, seed=0):
    n, h, w, ci, co, k, s, pad = geom
    rng = np.random.RandomState(seed)
    x = np.maximum(rng.randn(n, h, w, ci), 0).astype(np.float32)
    wt = (rng.randn(k, k, ci, co) / np.sqrt(k * k * ci)).astype(np.float32)
    (pt, pb), (pl, pr) = _pads(geom)
    ho, wo = (h + pt + pb - k) // s + 1, (w + pl + pr - k) // s + 1
    g = rng.randn(n, ho, wo, co).astype(np.float32)
    return x, wt, g


def run_port(m, padf, x, g, dtype):
    """Forward and backward of module m on x (NHWC numpy) with output
    gradient g: (y, dx, dw, db) as numpy, NHWC / HWIO."""
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).to(dtype) \
        .requires_grad_(True)
    y = m(padf(xt))
    y.backward(torch.from_numpy(g.transpose(0, 3, 1, 2).copy()).to(dtype))
    out = (y.detach().float().numpy().transpose(0, 2, 3, 1),
           xt.grad.float().numpy().transpose(0, 2, 3, 1),
           m.weight.grad.numpy().transpose(2, 3, 1, 0),
           None if m.bias is None else m.bias.grad.numpy())
    m.zero_grad()
    return out


def run_jax(geom, mode, x, wt, g, bias):
    n, h, w, ci, co, k, s, pad = geom
    mod = jactq.ConvQ8(co, (k, k), (s, s), pad, bias, jnp.float32, mode) \
        if mode else nn.Conv(co, (k, k), (s, s), pad, use_bias=bias)
    params = {'kernel': jnp.asarray(wt)}
    if bias:
        params['bias'] = jnp.arange(co, dtype=jnp.float32) * 0.1
    y, vjp = jax.vjp(lambda p, t: mod.apply({'params': p}, t), params,
                     jnp.asarray(x))
    dp, dx = vjp(jnp.asarray(g))
    return (np.asarray(y), np.asarray(dx), np.asarray(dp['kernel']),
            np.asarray(dp['bias']) if bias else None)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
@pytest.mark.parametrize('mode', [True, 'wgrad8'])
@pytest.mark.parametrize('name', list(GEOMS))
def test_convq8_forward_dx_db_are_the_plain_conv(name, mode, dtype):
    geom = GEOMS[name]
    x, wt, g = inputs(geom)
    bias = name != 'k7s2_stem'
    got = run_port(*port_conv(geom, mode, bias, wt), x, g, dtype)
    want = run_port(*port_conv(geom, False, bias, wt), x, g, dtype)
    for i, what in ((0, 'y'), (1, 'dx'), (3, 'db')):
        if want[i] is not None:
            np.testing.assert_array_equal(got[i], want[i], err_msg=what)
    # dw sees the 8-bit input (and, under wgrad8, the 8-bit g)
    assert _rel(got[2], want[2]) < 0.03


@pytest.mark.parametrize('mode', [True, 'wgrad8'])
@pytest.mark.parametrize('name', list(GEOMS))
def test_convq8_matches_jax(name, mode):
    geom = GEOMS[name]
    x, wt, g = inputs(geom, seed=1)
    bias = name != 'k7s2_stem'
    got = run_port(*port_conv(geom, mode, bias, wt), x, g, torch.float32)
    want = run_jax(geom, mode, x, wt, g, bias)
    assert _rel(got[0], want[0]) < 1e-5
    assert _rel(got[1], want[1]) < 1e-5
    assert _rel(got[2], want[2]) < (1e-6 if mode == 'wgrad8'
                                    and name != 'guard' else 1e-5)
    if bias:
        assert _rel(got[3], want[3]) < 1e-5


def test_guard_takes_the_dequant_route(monkeypatch):
    """N * Ho * Wo = 165,888 > INT32_SAFE_ACC: 'wgrad8' runs the dequant
    route (no wgrad_s8) and gives mode True's dw bit for bit."""
    geom = GEOMS['guard']
    x, wt, g = inputs(geom, seed=2)
    called = []
    real = actq_cuda.wgrad_s8
    monkeypatch.setattr(actq_cuda, 'wgrad_s8',
                        lambda *a, **k: called.append(1) or real(*a, **k))
    w8 = run_port(*port_conv(geom, 'wgrad8', True, wt), x, g, torch.float32)
    assert not called
    dq = run_port(*port_conv(geom, True, True, wt), x, g, torch.float32)
    np.testing.assert_array_equal(w8[2], dq[2])
    assert actq_cuda.INT32_SAFE_ACC == jactq._INT32_SAFE_ACC
    # one row fewer fits: the int8 route
    small = inputs((6, 144, 144, 2, 4, 3, 1, 'SAME'), seed=2)
    run_port(*port_conv((6, 144, 144, 2, 4, 3, 1, 'SAME'), 'wgrad8', True,
                        small[1]), *small[::2], torch.float32)
    assert called


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
@pytest.mark.parametrize('name', ['k3s1_same', 'k3s2_same', 'k7s2_stem',
                                  'k4s1_s2d'])
def test_quantizes_and_int32_wgrad_are_jax_bits(name, dtype):
    geom = GEOMS[name]
    n, h, w, ci, co, k, s, pad = geom
    x, _, g = inputs(geom, seed=3)
    x = x * 7.3 - 2.0          # signed, not a round scale
    jx = jnp.asarray(x, BF16[dtype])
    jq, jscale = jactq._quantize_per_sample(jx)
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).to(dtype)
    q, scale = actq_cuda.quant_s8(xt, 'x')
    np.testing.assert_array_equal(q.numpy().transpose(0, 2, 3, 1),
                                  np.asarray(jq))
    np.testing.assert_array_equal(scale.numpy(),
                                  np.asarray(jscale).reshape(-1))
    # the g-quantize of _q8w8_bwd
    jg = jnp.asarray(g, BF16[dtype])
    G = jg.astype(jnp.float32) * jscale
    sg = jnp.maximum(jnp.max(jnp.abs(G)), 1e-30) / 127.0
    jqg = jnp.clip(jnp.round(G / sg), -127, 127).astype(jnp.int8)
    gt = torch.from_numpy(g.transpose(0, 3, 1, 2).copy()).to(dtype)
    r = ci * k * k
    qgt, alpha = actq_cuda.quant_s8(gt, 'g', scale, alpha_len=r)
    ho, wo = g.shape[1:3]
    np.testing.assert_array_equal(
        actq_cuda.qg_of(qgt, n, ho, wo).numpy().transpose(0, 2, 3, 1),
        np.asarray(jqg))
    assert qgt.shape == (co, actq_cuda.padded_k(n * ho * wo))
    assert not qgt[:, n * ho * wo:].any()
    np.testing.assert_array_equal(alpha.numpy(), np.full(r, np.float32(sg)))
    # the int32 sums, and their rescale
    pads = _pads(geom)
    jdw = jactq._wgrad_conv(jq, jqg, (k, k), (s, s), pads,
                            preferred=jnp.int32)
    dw = actq_cuda.wgrad_s8(q, qgt, (k, k), s, pads)
    assert dw.dtype == torch.int32
    np.testing.assert_array_equal(dw.numpy().transpose(2, 3, 1, 0),
                                  np.asarray(jdw))
    dwf = actq_cuda.wgrad_s8(q, qgt, (k, k), s, pads, alpha)
    np.testing.assert_array_equal(
        dwf.numpy().transpose(2, 3, 1, 0),
        np.asarray(jdw.astype(jnp.float32) * sg))
    # the dequant copy of _q8_bwd
    want = np.asarray(jq.astype(BF16[dtype]) * jscale.astype(BF16[dtype]))
    got = actq_cuda.quant_s8(q, 'dequant', scale, dtype=dtype)
    assert got.dtype == dtype
    np.testing.assert_array_equal(
        got.float().numpy().transpose(0, 2, 3, 1), want.astype(np.float32))


# (N, C, H, W) of the dequant copy: per 315 (odd), 24 (per % 16 == 8),
# 1 at N = 70 (every chunk of the kernel's spans samples), 320 (a
# multiple of 16)
DEQUANT_SHAPES = {'odd': (3, 5, 7, 9), 'per8': (5, 3, 2, 4),
                  'per1': (70, 1, 1, 1), 'per16': (2, 16, 4, 5)}


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
@pytest.mark.parametrize('name', list(DEQUANT_SHAPES))
def test_dequant_is_jax_bits(name, dtype):
    """quant_s8 'dequant' against `_q8_bwd`'s copy q.astype(dt) *
    scale.astype(dt), bit for bit, at ragged sample sizes and every int8
    value."""
    shape = DEQUANT_SHAPES[name]
    rng = np.random.RandomState(len(name))
    q = rng.randint(-128, 128, shape).astype(np.int8)
    scale = (rng.rand(shape[0]) * 0.1 + 1e-3).astype(np.float32)
    jdt = BF16[dtype]
    want = jnp.asarray(q).astype(jdt) \
        * jnp.asarray(scale).reshape(-1, 1, 1, 1).astype(jdt)
    got = actq_cuda.quant_s8(torch.from_numpy(q), 'dequant',
                             torch.from_numpy(scale), dtype=dtype)
    assert got.dtype == dtype
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want).astype(np.float32))


# (N, H, W, Ci, Co, k, stride, JAX padding) with 64 input channels: the
# TMA route's layouts (column copies, a 1x1 stride-2 conv's even columns,
# a 1x1 conv's plane cut into rows, padded qgt rows)
TMA_GEOMS = {
    'k3s1_same': (2, 9, 10, 64, 12, 3, 1, 'SAME'),
    'k3s2_same': (2, 9, 11, 64, 12, 3, 2, 'SAME'),
    'k1s2_valid': (2, 10, 12, 64, 12, 1, 2, 'VALID'),
    'k1s1_valid': (2, 8, 12, 64, 12, 1, 1, 'VALID'),
}


@pytest.mark.parametrize('name', list(TMA_GEOMS))
def test_tma_layouts_are_jax_bits(name):
    """quant_s8 'x' and 'g' in the TMA route's layouts and wgrad_s8 on
    them give JAX's q, qg, int32 sums and f32 rescale bit for bit."""
    geom = TMA_GEOMS[name]
    n, h, w, ci, co, k, s, pad = geom
    x, _, g = inputs(geom, seed=7)
    x = x * 5.1 - 1.0
    pads = _pads(geom)
    plan = actq_cuda.wgrad_plan((n, ci, h, w), co, (k, k), s, pads)
    assert plan.route == 'tma'
    jq, jscale = jactq._quantize_per_sample(jnp.asarray(x))
    q, scale = actq_cuda.quant_s8(
        torch.from_numpy(x.transpose(0, 3, 1, 2).copy()), 'x', plan=plan)
    assert tuple(q.shape) == plan.q_shape
    np.testing.assert_array_equal(scale.numpy(),
                                  np.asarray(jscale).reshape(-1))
    # every column a tap reads (a 1x1 stride-2 conv reads the even ones)
    src, inside = actq_cuda._copy_columns(plan)
    cols = np.arange(w) if plan.plain_q else np.unique(src[inside].numpy())
    np.testing.assert_array_equal(
        actq_cuda.q_of(q, plan).numpy().transpose(0, 2, 3, 1)[:, :, cols],
        np.asarray(jq)[:, :, cols])
    G = jnp.asarray(g) * jscale
    sg = jnp.maximum(jnp.max(jnp.abs(G)), 1e-30) / 127.0
    jqg = jnp.clip(jnp.round(G / sg), -127, 127).astype(jnp.int8)
    qgt, alpha = actq_cuda.quant_s8(
        torch.from_numpy(g.transpose(0, 3, 1, 2).copy()), 'g', scale,
        alpha_len=ci * k * k, plan=plan)
    assert qgt.shape == (co, plan.kp)
    np.testing.assert_array_equal(
        actq_cuda.qg_of(qgt, n, plan.ho, plan.wo, plan).numpy()
        .transpose(0, 2, 3, 1), np.asarray(jqg))
    jdw = jactq._wgrad_conv(jq, jqg, (k, k), (s, s), pads,
                            preferred=jnp.int32)
    dw = actq_cuda.wgrad_s8(q, qgt, (k, k), s, pads, plan=plan)
    np.testing.assert_array_equal(dw.numpy().transpose(2, 3, 1, 0),
                                  np.asarray(jdw))
    dwf = actq_cuda.wgrad_s8(q, qgt, (k, k), s, pads, alpha, plan=plan)
    np.testing.assert_array_equal(
        dwf.numpy().transpose(2, 3, 1, 0),
        np.asarray(jdw.astype(jnp.float32) * sg))


@pytest.mark.parametrize('name', ['k3s2_same', 'k1s1_valid'])
def test_convq8_tma_route_matches_jax(name):
    """ConvQ8 'wgrad8' on convs whose weight gradient takes the TMA
    route's layouts: forward, dx and the bias gradient the plain conv's,
    dw JAX's within test_convq8_matches_jax's bound."""
    geom = TMA_GEOMS[name]
    x, wt, g = inputs(geom, seed=8)
    got = run_port(*port_conv(geom, 'wgrad8', True, wt), x, g,
                   torch.float32)
    want = run_jax(geom, 'wgrad8', x, wt, g, True)
    plain = run_port(*port_conv(geom, False, True, wt), x, g, torch.float32)
    for i in (0, 1, 3):
        np.testing.assert_array_equal(got[i], plain[i])
    assert _rel(got[2], want[2]) < 1e-6


def test_gather_plain_is_the_conv_sums():
    """The kernel's gather and product, written as im2col_torch @ qgt^T,
    give wgrad_s8_torch's sums."""
    geom = GEOMS['k3s2_same']
    n, h, w, ci, co, k, s, pad = geom
    rng = np.random.RandomState(4)
    q = torch.from_numpy(rng.randint(-127, 128, (n, ci, h, w)).astype(
        np.int8))
    pads = _pads(geom)
    ho, wo = int8_cuda.conv_out_hw(h, w, k, k, s, pads)
    kp = actq_cuda.padded_k(n * ho * wo)
    qgt = torch.zeros((co, kp), dtype=torch.int8)
    qgt[:, :n * ho * wo] = torch.from_numpy(
        rng.randint(-127, 128, (co, n * ho * wo)).astype(np.int8))
    p = actq_cuda.im2col_torch(q, (k, k), s, pads)
    assert p.shape == (ci * k * k, kp)
    acc = (qgt.double() @ p.double().t()).to(torch.int32)
    np.testing.assert_array_equal(
        acc.view(co, ci, k, k).numpy(),
        actq_cuda.wgrad_s8_torch(q, qgt, (k, k), s, pads).numpy())


def test_convq8_saves_no_float_copy_of_x():
    geom = GEOMS['k3s1_same']
    x, wt, g = inputs(geom)
    saved = []

    def pack(t):
        saved.append((tuple(t.shape), t.dtype))
        return t

    for dtype in (torch.float32, torch.bfloat16):
        m, padf = port_conv(geom, 'wgrad8', True, wt)
        xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).to(dtype) \
            .requires_grad_(True)
        saved.clear()
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            y = m(xt)
        y.backward(torch.ones_like(y))
        floats = [s for s in saved if s[1].is_floating_point]
        assert (tuple(xt.shape), torch.int8) in saved
        assert all(s[0] != tuple(xt.shape) for s in floats), saved


# ---------------------------------------------------------------------------
# whole models and steps


def tiny(cls, backbone, **over):
    cfg = cls()
    for k, v in {**dict(BACKBONE=backbone, BOTTLENECK_WIDTH=8,
                        BRANCH_SIZE=16, IMAGE_RESIZE_MODE='square',
                        IMAGE_MAX_DIM=64, IMAGE_MIN_DIM=64, REGRESS_LOC=True,
                        REGRESS_ORI=True, ORIENTATION_PARAM='quaternion',
                        ROT_AUG=False), **over}.items():
        setattr(cfg, k, v)
    cfg.update()
    return cfg


def _grads_jax_layout(model):
    sd = dict(model.state_dict())
    for name, p in model.named_parameters():
        sd[name] = p.grad
    return params_to_jax_layout(sd)['params']


@pytest.mark.parametrize('mode', [True, 'wgrad8'])
@pytest.mark.parametrize('backbone', ['resnet18', 'resnet50'])
def test_model_loss_and_grads_match_jax(backbone, mode):
    """The JAX package's test_actq_model_forward_exact_grads_close, with
    the port's seeded weights on both sides (Euler-angle regression: the
    sum of squares of a unit quaternion is constant, its gradient only
    rounding noise)."""
    x = np.random.RandomState(0).rand(2, 64, 64, 3).astype(np.float32)
    over = dict(TRAIN_ACT_Q8=mode, ORIENTATION_PARAM='euler_angles')
    model = build_model(tiny(Config, backbone, **over), 'cpu')
    tree = params_to_jax_layout(model.state_dict())
    out = model(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    loss = (out['loc'] ** 2).sum() + (out['ori'] ** 2).sum()
    loss.backward()
    loss = float(loss.detach())
    # the forward is exact: the loss is the plain model's, bit for bit
    plain = build_model(tiny(Config, backbone, ORIENTATION_PARAM='euler_angles'),
                        'cpu')
    with torch.no_grad():
        out = plain(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
        assert float((out['loc'] ** 2).sum() + (out['ori'] ** 2).sum()) \
            == loss
    jmodel = jax_build_model(tiny(JaxConfig, backbone, **over))

    def loss_fn(params):
        o = jmodel.apply({'params': params,
                          'batch_stats': tree['batch_stats']},
                         jnp.asarray(x), training=True)
        return jnp.sum(o['loc'] ** 2) + jnp.sum(o['ori'] ** 2)

    jl, jg = jax.jit(jax.value_and_grad(loss_fn))(tree['params'])
    assert abs(loss - float(jl)) <= 1e-5 * abs(float(jl))
    got = dict(jax.tree_util.tree_leaves_with_path(_grads_jax_layout(model)))
    worst = 0.0
    for path, a in jax.tree_util.tree_leaves_with_path(jg):
        if np.linalg.norm(np.asarray(a)) > 1e-8:
            worst = max(worst, _rel(got[path], a))
    assert worst < 2e-3, worst


def _molded(seed, n):
    rng = np.random.RandomState(seed)
    q = rng.randn(n, 4)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return {'images': (rng.rand(n, 64, 64, 3) * 100).astype(np.float32),
            'gt_loc': (rng.randn(n, 3) + 10.0).astype(np.float32),
            'gt_ori': q.astype(np.float32)}


def _flat(params):
    leaves = jax.tree_util.tree_leaves_with_path(params)
    return [jax.tree_util.keystr(p) for p, _ in leaves], np.concatenate(
        [np.ravel(np.asarray(v, np.float64)) for _, v in leaves])


@pytest.mark.parametrize('f16', [False, True], ids=['f32', 'F16'])
def test_train_step_matches_jax(f16):
    """One 'wgrad8' train step of the tiny ResNet-18 on both sides."""
    over = dict(TRAIN_ACT_Q8='wgrad8', F16=f16, IMAGES_PER_GPU=4)
    cfg, jcfg = tiny(Config, 'resnet18', **over), \
        tiny(JaxConfig, 'resnet18', **over)
    batch = _molded(0, 4)
    model = build_model(cfg, 'cpu')
    tree = params_to_jax_layout(model.state_dict())
    step = make_train_step(model, cfg, make_optimizer(cfg), device='cpu')
    tm = step(W.molded_batch(batch), torch.Generator().manual_seed(0))
    jmodel = jax_build_model(jcfg)
    tx = jax_make_optimizer(jcfg)
    state = jstate.state_from_params(tree['params'], tree['batch_stats'], tx)
    jstep = jax_make_train_step(
        jmodel, jcfg, tx, trainable=jstate.trainable_mask(state.params, 'all'))
    state, jm = jstep(state, {k: jnp.asarray(v) for k, v in batch.items()},
                      jax.random.PRNGKey(0))
    names_j, wj = _flat(jax.device_get(state.params))
    names_t, wt = _flat(params_to_jax_layout(model.state_dict())['params'])
    assert names_j == names_t
    _, w0 = _flat(tree['params'])
    units = np.linalg.norm(wt - wj) / np.linalg.norm(wj - w0)
    assert units <= (0.35 if f16 else 1e-3), units
    for k in ('loss', 'loc_loss', 'ori_loss'):
        assert abs(float(tm[k]) - float(jm[k])) \
            <= (3e-2 if f16 else 1e-5) * abs(float(jm[k])), k


# chip_smoke.py phase 8g's recipes at a tiny width (the card runs them at
# full width): config 5's keypoint head under F16 and REMAT in both modes
# (ResNet-50 standing for its ResNet-101: the same blocks, fewer of them),
# config 2's batch-1 ResNet-18, whose C = 3 stem's weight gradient takes
# wgrad_s8's gather route, and the flagship's classification head in f32
RECIPES = {
    'config5_true': ('resnet50', dict(REGRESS_KEYPOINTS=True, F16=True,
                                      REMAT=True, TRAIN_ACT_Q8=True)),
    'config5_wgrad8': ('resnet50', dict(REGRESS_KEYPOINTS=True, F16=True,
                                        REMAT=True, TRAIN_ACT_Q8='wgrad8')),
    'config2_b1_wgrad8': ('resnet18', dict(TRAIN_ACT_Q8='wgrad8',
                                           IMAGES_PER_GPU=1)),
    'flagship_f32_wgrad8': ('resnet50', dict(TRAIN_ACT_Q8='wgrad8',
                                             REGRESS_ORI=False,
                                             ORI_BINS_PER_DIM=6)),
}


def _recipe_batch(cfg, jcfg, seed):
    """A molded batch of the recipe's heads: keypoint targets of
    plausible poses, or location and orientation (quaternions, or the
    JAX package's PMFs for a classification head)."""
    from ursonet_tpu.data.urso import encode_as_keypoints
    from ursonet_tpu.ops import encoders as jenc
    n = cfg.BATCH_SIZE
    batch = _molded(seed, n)
    if cfg.REGRESS_KEYPOINTS:
        k1, k2 = encode_as_keypoints(batch.pop('gt_ori'), batch['gt_loc'],
                                     3.0)
        batch.update(gt_k1=k1.astype(np.float32), gt_k2=k2.astype(np.float32))
    elif not cfg.REGRESS_ORI:
        grid = jenc.build_ori_grid(jcfg.ORI_BINS_PER_DIM)
        batch['gt_ori'] = jenc.encode_ori_pmf(
            batch['gt_ori'], grid.quat, grid.mask, jcfg.BETA,
            jcfg.ORI_BINS_PER_DIM).astype(np.float32)
    return batch


@pytest.mark.parametrize('recipe', list(RECIPES))
def test_recipe_step_matches_jax(recipe):
    """One train step of each recipe on both sides (the port's seeded
    weights), at the file's bounds for its compute type; the launches the
    port's step records are the recipe's: under REMAT every block's convs
    quantized again in the recompute (the stem not), at batch 1 the
    stem's weight gradient on the gather route and the others on the TMA
    route."""
    backbone, over = RECIPES[recipe]
    over = {'IMAGES_PER_GPU': 2, **over}
    f16 = over.get('F16', False)
    cfg, jcfg = tiny(Config, backbone, **over), tiny(JaxConfig, backbone,
                                                     **over)
    batch = _recipe_batch(cfg, jcfg, 9)
    model = build_model(cfg, 'cpu', torch.Generator().manual_seed(3))
    tree = params_to_jax_layout(model.state_dict())
    step = make_train_step(model, cfg, make_optimizer(cfg), device='cpu')
    actq_cuda.calls = []
    try:
        tm = step(W.molded_batch(batch), torch.Generator().manual_seed(0))
    finally:
        calls, actq_cuda.calls = actq_cuda.calls, None
    convs = [c[:4] for c in memory.backbone_convs(cfg)]
    xs = [a['shape'] for n, a in calls if n == 'quant_s8' and a['mode'] == 'x']
    wg = {a['q']: a['route'] for n, a in calls if n == 'wgrad_s8'}
    assert xs[:len(convs)] == convs
    if cfg.REMAT:
        # every conv but the stem a second time, in its block's recompute
        assert sorted(xs[len(convs):]) == sorted(convs[1:])
    else:
        assert len(xs) == len(convs)
    if cfg.TRAIN_ACT_Q8 == 'wgrad8':
        assert wg == {c: 'ragged' if c[1] < 64 else 'tma' for c in convs}
        assert wg[convs[0]] == 'ragged' and convs[0][0] \
            == cfg.BATCH_SIZE
    else:
        assert not wg
    jmodel = jax_build_model(jcfg)
    tx = jax_make_optimizer(jcfg)
    state = jstate.state_from_params(tree['params'], tree['batch_stats'], tx)
    jstep = jax_make_train_step(
        jmodel, jcfg, tx, trainable=jstate.trainable_mask(state.params, 'all'))
    state, jm = jstep(state, {k: jnp.asarray(v) for k, v in batch.items()},
                      jax.random.PRNGKey(0))
    names_j, wj = _flat(jax.device_get(state.params))
    names_t, wt = _flat(params_to_jax_layout(model.state_dict())['params'])
    assert names_j == names_t
    _, w0 = _flat(tree['params'])
    units = np.linalg.norm(wt - wj) / np.linalg.norm(wj - w0)
    assert units <= (0.35 if f16 else 1e-3), units
    assert set(tm) == set(jm)
    for k in jm:
        assert abs(float(tm[k]) - float(jm[k])) \
            <= (3e-2 if f16 else 1e-5) * abs(float(jm[k])), k


def test_remat_narrow_steps_as_without():
    """TRAIN_ACT_Q8 x REMAT: the recompute quantizes the same inputs, so
    the gradients are those without REMAT, bit for bit."""
    x = torch.from_numpy(np.random.RandomState(5).rand(2, 3, 64, 64)
                         .astype(np.float32))
    grads = {}
    for remat in (False, 'narrow', True):
        cfg = tiny(Config, 'resnet50', TRAIN_ACT_Q8='wgrad8', REMAT=remat)
        model = build_model(cfg, 'cpu')
        out = model(x)
        ((out['loc'] ** 2).sum() + (out['ori'] ** 2).sum()).backward()
        grads[remat] = {n: p.grad.clone() for n, p in model.named_parameters()}
    for remat in ('narrow', True):
        for n, g in grads[False].items():
            assert torch.equal(grads[remat][n], g), (remat, n)


def test_data_parallel_world_of_two(tmp_path):
    """Two 'wgrad8' steps in a gloo world of 2 data ranks (the g-scale
    all-reduced, the int32 guard on the global batch) against one
    process on the whole batch."""
    cfg = W.tiny_config(IMAGES_PER_GPU=8, TRAIN_ACT_Q8='wgrad8')
    whole = build_model(cfg, 'cpu').state_dict()
    batch = _molded(6, 8)
    torch.save({'whole': whole, 'batch': batch}, tmp_path / 'in_actq.pt')
    env = dict(os.environ, OMP_NUM_THREADS='1', TORCH_WORKER_MESH='2x1')
    worker = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          'torch_parallel_worker.py')
    procs = [subprocess.Popen([sys.executable, worker, str(r), '2',
                               str(tmp_path), 'actq'], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT) for r in range(2)]
    model = build_model(cfg, 'cpu')
    step = make_train_step(model, cfg, make_optimizer(cfg), device='cpu')
    metrics = [{k: float(v) for k, v in step(
        W.molded_batch(batch), torch.Generator().manual_seed(100 + i))
        .items()} for i in range(2)]
    outs = [p.communicate(timeout=600)[0].decode() for p in procs]
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r}:\n{outs[r][-4000:]}"
    got_m, got_sd, _ = torch.load(tmp_path / 'actq_r0.pt', weights_only=False)
    for mo, mw in zip(got_m, metrics):
        for k in mw:
            assert abs(mo[k] - mw[k]) <= 1e-5 * abs(mw[k]), k
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(got_sd[k].numpy(), v.numpy(), rtol=2e-4,
                                   atol=2e-5, err_msg=k)
