"""LEARNABLE_LOSS_WEIGHTS in the port against the JAX package: the
Kendall log-variances `loss_log_vars` (zeros at first, one a loss part)
weight the losses as Σ exp(−sₖ)·wₖ·Lₖ + sₖ, train with the model's
parameters under Keras SGD and stay out of the L2 term.

Tolerances: compute_losses within 1e-6 relative; one train step at
tests/test_torch_train.py's bounds (metrics 1e-5 relative, update 1e-3
in update units), the log-variances' own moves within 1e-3 of JAX's.
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from ursonet_tpu.models.ursonet import build_model as jax_build_model
from ursonet_tpu.train import losses as jlosses
from ursonet_tpu.train import state as jstate
from ursonet_tpu.train.optim import make_optimizer as jax_make_optimizer
from ursonet_tpu.train.step import make_train_step as jax_make_train_step
from ursonet_torch.checkpoint.convert import params_from_jax, \
    params_to_jax_layout
from ursonet_torch.models.ursonet import build_model
from ursonet_torch.train import losses as tlosses
from ursonet_torch.train.optim import make_optimizer
from ursonet_torch.train.state import trainable_mask
from ursonet_torch.train.step import make_train_step
from test_torch_model import jax_variables
from test_torch_train import _batch, _flat, _rel, _torch_batch
from torch_parity import small_configs

torch.set_num_threads(1)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def test_compute_losses_with_log_vars_match_jax():
    jcfg, tcfg = small_configs()
    batch = _batch(jcfg, seed=3)
    rng = np.random.RandomState(3)
    out = {'loc': rng.randn(2, 3).astype(np.float32) * 10,
           'ori': np.abs(rng.randn(2, 6 ** 3)).astype(np.float32)}
    s = {'loc_loss': np.float32(0.7), 'ori_loss': np.float32(-1.3)}
    jt, jp = jlosses.compute_losses(
        {k: jnp.asarray(v) for k, v in out.items()}, batch, jcfg,
        log_vars={k: jnp.asarray(v) for k, v in s.items()})
    tt, tp = tlosses.compute_losses(
        {k: torch.from_numpy(v) for k, v in out.items()},
        {k: torch.from_numpy(v) for k, v in batch.items()}, tcfg,
        {k: torch.tensor(v) for k, v in s.items()})
    assert _rel(tt, jt) <= 1e-6
    for k in jp:
        assert _rel(tp[k], jp[k]) <= 1e-6, k


def test_train_step_with_log_vars_matches_jax():
    jcfg, tcfg = small_configs(LEARNABLE_LOSS_WEIGHTS=True)
    tree = jax_variables(jax_build_model(jcfg), (2, 64, 64, 3), seed=2)
    log_vars = {'loc_loss': np.float32(0.4), 'ori_loss': np.float32(-0.2)}
    tree['params']['loss_log_vars'] = log_vars
    batch = _batch(jcfg, seed=4)
    tx = jax_make_optimizer(jcfg)
    state = jstate.state_from_params(tree['params'], tree['batch_stats'], tx)
    jstep = jax_make_train_step(
        jax_build_model(jcfg), jcfg, tx,
        trainable=jstate.trainable_mask(state.params, 'all'))
    state, jm = jstep(state, {k: jnp.asarray(v) for k, v in batch.items()},
                      jax.random.PRNGKey(0))

    model = build_model(tcfg, device='cpu')
    assert sorted(dict(model.loss_log_vars)) == sorted(log_vars)
    assert all(float(v.detach()) == 0 for v in model.loss_log_vars.values())
    model.load_state_dict(params_from_jax(tree))
    names = [n for n, _ in tlosses.regularized_params(model)]
    assert names and not any(n.startswith('loss_log_vars') for n in names)
    reg_before = float(tlosses.l2_regularization(
        model, tcfg.WEIGHT_DECAY).detach())
    tstep = make_train_step(model, tcfg, make_optimizer(tcfg),
                            trainable=trainable_mask(model, 'all'),
                            device='cpu')
    tm = tstep(_torch_batch(batch))
    for k, v in jm.items():
        assert _rel(tm[k], v) <= 1e-5, k
    assert _rel(tm['l2_reg'], reg_before) <= 1e-6
    wt = params_to_jax_layout(model.state_dict())['params']
    wj = _np_tree(state.params)
    names_j, fj = _flat(wj)
    names_t, ft = _flat(wt)
    assert names_j == names_t
    _, f0 = _flat(tree['params'])
    assert np.linalg.norm(ft - fj) / np.linalg.norm(fj - f0) <= 1e-3
    for k, v in log_vars.items():
        moved = float(wj['loss_log_vars'][k]) - float(v)
        assert moved != 0
        assert abs(float(wt['loss_log_vars'][k]) - float(v) - moved) \
            <= 1e-3 * abs(moved), k
