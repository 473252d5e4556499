"""The port's cyclical learning rate and Adam (amsgrad)
(`ursonet_torch/train/optim.py`) against the JAX package's
`clr_schedule` and optax, a config-4-shaped train step with CLR against
the JAX step, and Adam + CLR train states across both packages.

Tolerances: CLR within 1e-7 (measured equal: both compute in float32 in
the same order); amsgrad within 1e-6 over 10 steps (measured equal);
the train steps within 1e-3 in update units under SGD (‖w_port − w_jax‖
/ ‖w_jax − w_0‖, tests/test_torch_train.py's bound) and 1e-2 under Adam
(UPDATE_UNITS says why), with each step's
learning rate equal to JAX's schedule at that count; train states
(slots, counts, the injected learning rate) cross both ways exactly.
"""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from ursonet_tpu.checkpoint import store as jstore
from ursonet_tpu.engine import UrsoNet as JaxUrsoNet
from ursonet_tpu.models.ursonet import build_model as jax_build_model
from ursonet_tpu.train import state as jstate
from ursonet_tpu.train.optim import clr_schedule as jax_clr
from ursonet_tpu.train.optim import make_optimizer as jax_make_optimizer
from ursonet_tpu.train.step import make_train_step as jax_make_train_step
from ursonet_torch.checkpoint import store
from ursonet_torch.checkpoint.convert import params_from_jax, \
    params_to_jax_layout
from ursonet_torch.data.synthetic import make_urso_dataset
from ursonet_torch.data.urso import Urso
from ursonet_torch.engine import UrsoNet
from ursonet_torch.models.ursonet import build_model
from ursonet_torch.train.optim import AMSGrad, KerasSGD, clr_schedule, \
    make_optimizer
from ursonet_torch.train.state import trainable_mask
from ursonet_torch.train.step import make_train_step
from test_torch_model import jax_variables
from test_torch_train import _batch, _flat, _torch_batch
# run_dir is a fixture
from torch_parity import run_dir, small_configs  # noqa: F401

torch.set_num_threads(1)

COUNTS = [0, 1, 2, 1999, 2000, 2001, 3999, 4000, 4001, 7999, 8000, 8001,
          12000, 16000, 23999, 24000, 100003]


@pytest.mark.parametrize('mode,gamma', [
    ('triangular', 1.0), ('triangular2', 1.0), ('exp_range', 0.99994)])
def test_clr_matches_jax(mode, gamma):
    want = jax_clr(1e-4, 5e-4, 2000, mode, gamma)
    got = clr_schedule(1e-4, 5e-4, 2000, mode, gamma)
    for c in COUNTS:
        assert abs(got(c) - float(want(jnp.int32(c)))) <= 1e-7, c
    assert got(0) == pytest.approx(1e-4, rel=1e-6)
    if mode != 'exp_range':
        assert got(2000) == pytest.approx(5e-4, rel=1e-6)
    with pytest.raises(ValueError, match='CLR mode'):
        clr_schedule(1e-4, 5e-4, 10, 'sawtooth')


@pytest.mark.parametrize('clr', [False, True])
def test_amsgrad_matches_optax(clr):
    rng = np.random.RandomState(int(clr))
    shapes = [(3, 4), (5,), (2, 2, 2)]
    w0 = [rng.randn(*s).astype(np.float32) for s in shapes]
    lr = jax_clr(1e-3, 5e-3, 3) if clr else 2e-3
    inner = optax.inject_hyperparams(
        lambda learning_rate: optax.amsgrad(learning_rate))(
            learning_rate=lr) if clr else optax.amsgrad(lr)
    tx = optax.chain(optax.clip_by_global_norm(5.0), inner)
    jp = [jnp.asarray(w) for w in w0]
    st = tx.init(jp)
    tp = [torch.from_numpy(w.copy()) for w in w0]
    opt = AMSGrad(clr_schedule(1e-3, 5e-3, 3) if clr else 2e-3, 5.0)
    for i in range(10):
        # large and small gradients in turn: the clip acts on some steps
        # and the running maximum of the second moment on others
        gs = [(rng.randn(*s) * (4.0 if i % 2 else 0.3)).astype(np.float32)
              for s in shapes]
        u, st = tx.update([jnp.asarray(g) for g in gs], st, jp)
        jp = optax.apply_updates(jp, u)
        opt.step(tp, [torch.from_numpy(g.copy()) for g in gs])
        for a, b in zip(jp, tp):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                       atol=1e-6)
    assert opt.count == 10
    # torch's amsgrad keeps the maximum of the raw moment: another update
    tw = [torch.from_numpy(w.copy()).requires_grad_() for w in w0]
    ref = torch.optim.Adam(tw, lr=2e-3, amsgrad=True)
    mine = [torch.from_numpy(w.copy()) for w in w0]
    opt = AMSGrad(2e-3, 1e9)
    for i in range(2):
        gs = [torch.from_numpy((rng.randn(*s) * (1 + 9 * i))
                               .astype(np.float32)) for s in shapes]
        for p, g in zip(tw, gs):
            p.grad = g.clone()
        ref.step()
        opt.step(mine, [g.clone() for g in gs])
    assert max(float((a.detach() - b).abs().max())
               for a, b in zip(tw, mine)) > 1e-6


def test_make_optimizer_reads_the_config():
    _, cfg = small_configs(CLR=True, BASE_LEARNING_RATE=1e-4,
                           MAX_LEARNING_RATE=3e-4, CLR_STEP_SIZE=10)
    tx = make_optimizer(cfg)
    assert isinstance(tx, KerasSGD) and tx.lr_at(10) == pytest.approx(3e-4)
    _, cfg = small_configs(OPTIMIZER='adam')
    tx = make_optimizer(cfg)
    assert isinstance(tx, AMSGrad) and tx.lr_at(7) == cfg.LEARNING_RATE
    _, cfg = small_configs(OPTIMIZER='rmsprop')
    with pytest.raises(ValueError, match='OPTIMIZER'):
        make_optimizer(cfg)


@pytest.fixture(scope='module')
def jax_init():
    jcfg, _ = small_configs()
    return jax_variables(jax_build_model(jcfg), (2, 64, 64, 3))


# Update units the train steps are held to: SGD (config 4's optimizer)
# at 1e-3 (tests/test_torch_train.py's bound); Adam at 1e-2, because it
# divides each update by the root of the second moment, so a parameter
# whose gradient is at the level of float rounding still moves by about
# the learning rate, in a direction the last place of that gradient
# decides (measured 1.15e-3 after the second step).
UPDATE_UNITS = {'SGD': 1e-3, 'ADAM': 1e-2}


@pytest.mark.parametrize('optimizer', ['SGD', 'ADAM'])
def test_config4_train_steps_with_clr_match_jax(jax_init, optimizer):
    """Two steps of config 4's recipe at the small size (orientation
    classification, location regression, CLR with a step size of 1 so
    that the learning rate moves every step) on both sides."""
    kw = dict(CLR=True, BASE_LEARNING_RATE=1e-4, MAX_LEARNING_RATE=2e-3,
              CLR_STEP_SIZE=1, OPTIMIZER=optimizer)
    jcfg, tcfg = small_configs(**kw)
    tree = jax_init
    jtx = jax_make_optimizer(jcfg)
    state = jstate.state_from_params(tree['params'], tree['batch_stats'],
                                     jtx)
    jstep = jax_make_train_step(
        jax_build_model(jcfg), jcfg, jtx,
        trainable=jstate.trainable_mask(state.params, 'all'), jit=False)
    model = build_model(tcfg, device='cpu')
    model.load_state_dict(params_from_jax(tree))
    ttx = make_optimizer(tcfg)
    tstep = make_train_step(model, tcfg, ttx,
                            trainable=trainable_mask(model, 'all'),
                            device='cpu')
    sched = jax_clr(1e-4, 2e-3, 1)
    _, w0 = _flat(tree['params'])
    for i in range(2):
        batch = _batch(jcfg, seed=i)
        state, _ = jstep(state, {k: jnp.asarray(v) for k, v in batch.items()},
                         jax.random.PRNGKey(0))
        tstep(_torch_batch(batch))
        assert ttx.last_lr == float(sched(jnp.int32(i)))
        _, wj = _flat(jax.tree_util.tree_map(np.asarray, state.params))
        _, wt = _flat(params_to_jax_layout(model.state_dict())['params'])
        assert np.linalg.norm(wt - wj) / np.linalg.norm(wj - w0) <= \
            UPDATE_UNITS[optimizer], i
    assert ttx.count == 2


# --------------------------------------------------------------------------
# Adam + CLR train states across the packages


ADAM_CLR = dict(OPTIMIZER='ADAM', CLR=True, BASE_LEARNING_RATE=1e-4,
                MAX_LEARNING_RATE=1e-3, CLR_STEP_SIZE=2, ROT_AUG=False,
                DATA_ON_DEVICE=False, NATIVE_LOADER=False,
                STEPS_PER_EPOCH=2, VALIDATION_STEPS=1)


@pytest.fixture(scope='module')
def urso_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp('urso'))
    make_urso_dataset(d, n_per_subset=6, width=96, height=72)
    return d


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _port_opt_tree(eng):
    return store.opt_state_tree(eng.model, eng.tx, eng.slots)


def _trees_equal(a, b, path=''):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            _trees_equal(a[k], b[k], f'{path}/{k}')
    else:
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a),
                                      err_msg=path)


@pytest.mark.parametrize('clr', [True, False])
def test_adam_state_resumes_across_packages(urso_dir, run_dir, clr):
    """The port trains one epoch with Adam (and CLR); the JAX engine
    resumes its run dir and holds the same opt_state. A JAX state with
    moved slots resumes in the port, and the port writes it back in the
    JAX tree bit for bit."""
    kw = {**ADAM_CLR, 'CLR': clr}
    jcfg, tcfg = small_configs(**kw)
    teng = UrsoNet('training', tcfg, str(run_dir / 'port'), device='cpu')
    ds = {s: Urso() for s in ('train', 'val')}
    for s, d in ds.items():
        d.load_dataset(urso_dir, tcfg, s)
    teng.train(ds['train'], ds['val'], tcfg.LEARNING_RATE, 1,
               log_fn=lambda *a: None)
    assert teng.tx.count == teng.step == 2
    assert set(teng.slots) == {'mu', 'nu', 'nu_max'}

    # JAX reads the port's run dir
    jeng = JaxUrsoNet('training', jcfg, str(run_dir / 'jax'))
    assert jeng.resume_state(teng.log_dir)
    want = _np(jax.tree_util.tree_map(
        lambda x: x, __import__('flax').serialization.to_state_dict(
            jeng.state.opt_state)))
    _trees_equal(want, _port_opt_tree(teng))
    if clr:
        assert float(want['1']['hyperparams']['learning_rate']) == \
            np.float32(teng.tx.lr_at(1))

    # the port reads a JAX state whose slots moved
    jtx = jax_make_optimizer(jcfg)
    params = jeng.state.params
    opt_state = jeng.state.opt_state
    rng = np.random.RandomState(3)
    for _ in range(3):
        grads = jax.tree_util.tree_map(
            lambda p: jnp.asarray(rng.randn(*p.shape).astype(np.float32)),
            params)
        u, opt_state = jtx.update(grads, opt_state, params)
        params = optax.apply_updates(params, u)
    jstate_ = jeng.state.replace(params=params, opt_state=opt_state,
                                 step=jnp.int32(5))
    run = run_dir / 'jax_run'
    os.makedirs(run)
    jstore.save_state(str(run / 'state_latest.msgpack'), jstate_, 3)
    teng2 = UrsoNet('training', tcfg, str(run_dir / 'port2'), device='cpu')
    assert teng2.resume_state(str(run))
    assert (teng2.step, teng2.epoch, teng2.tx.count) == (5, 3, 5)
    from flax import serialization
    _trees_equal(_np(serialization.to_state_dict(opt_state)),
                 _port_opt_tree(teng2))
    _trees_equal(_np(params),
                 params_to_jax_layout(teng2.model.state_dict())['params'])


def test_adam_clr_resume_continues_exactly(urso_dir, run_dir):
    """Two epochs in one call against one epoch, a resume in a fresh
    engine and another: the same weights and slots bit for bit, and the
    learning rate continues the cycle."""
    # resident: each epoch's permutation is keyed by the epoch
    _, tcfg = small_configs(**{**ADAM_CLR, 'DATA_ON_DEVICE': True})
    ds = {s: Urso() for s in ('train', 'val')}
    for s, d in ds.items():
        d.load_dataset(urso_dir, tcfg, s)

    def engine(name):
        return UrsoNet('training', tcfg, str(run_dir / name), device='cpu')

    whole = engine('whole')
    whole.train(ds['train'], ds['val'], tcfg.LEARNING_RATE, 2,
                log_fn=lambda *a: None)
    first = engine('first')
    first.train(ds['train'], ds['val'], tcfg.LEARNING_RATE, 1,
                log_fn=lambda *a: None)
    second = engine('second')
    assert second.resume_state(first.log_dir)
    assert second.tx.count == 2
    second.train(ds['train'], ds['val'], tcfg.LEARNING_RATE, 2,
                 log_fn=lambda *a: None)
    assert second.tx.last_lr == whole.tx.last_lr == \
        pytest.approx(clr_schedule(1e-4, 1e-3, 2)(3))
    for k, v in whole.model.state_dict().items():
        assert torch.equal(second.model.state_dict()[k], v), k
    for s in whole.slots:
        for n, v in whole.slots[s].items():
            assert torch.equal(second.slots[s][n], v), (s, n)
