"""Weights between the JAX package's layout and the port's `state_dict`.

The JAX package keeps its variables as {'params': ..., 'batch_stats': ...}
nested dicts keyed by Keras layer names, with Flax's leaf names and
layouts. The port's modules carry the same layer names, so the two map
name for name:

  Flax                                   port
  <path>/kernel  conv HWIO               <path>.weight  OIHW
  <path>/kernel  dense [in, out]         <path>.weight  [out, in]
  <path>/bias                            <path>.bias
  <bn path>/bn/scale, bn/bias            <bn path>.weight, .bias
  batch_stats <bn path>/bn/mean, bn/var  <bn path>.running_mean, .running_var

(the synthetic 'bn' level of the JAX `FrozenAwareBN` wrapper is dropped).
Batch-norm layers are the ones whose Keras name starts with 'bn'
('bn_conv1', 'bn2a_branch2a'), the basic blocks' 'stage{S}_unit{U}_bn2'
and, under TRAIN_BN=True, the heads' '{loc,ori}_bn_{i}' (`is_bn_layer`).
The
Kendall log-variances map as they are: params/loss_log_vars/<loss> <->
loss_log_vars.<loss>, 0-d.

A model whose heads are split over a mesh's 'model' axis
(`parallel/sharding.py`) holds shards: `params_from_jax(tree, mesh,
split)` gives this rank's shards of a whole tree, and
`params_to_jax_layout(state_dict, mesh, split)` the whole tree of a
rank's shards (collective over 'model'). The trees on disk are always
whole.
"""

from __future__ import annotations

import re

import numpy as np
import torch

LOG_VARS = 'loss_log_vars'
_BN_LAYER = re.compile(r'bn.*|stage\d+_unit\d+_bn2|(loc|ori)_bn_\d+')


def is_bn_layer(name: str) -> bool:
    """Whether a Keras layer name is a batch norm's."""
    return bool(_BN_LAYER.fullmatch(name))


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, 'items'):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _to_torch_layout(leaf: str, a: np.ndarray) -> np.ndarray:
    if leaf == 'kernel':
        if a.ndim == 4:
            return a.transpose(3, 2, 0, 1)        # HWIO -> OIHW
        if a.ndim == 2:
            return a.T                            # [in,out] -> [out,in]
        raise ValueError(f"kernel of rank {a.ndim}")
    return a


_PARAM_LEAF = {'kernel': 'weight', 'bias': 'bias', 'scale': 'weight'}
_STAT_LEAF = {'mean': 'running_mean', 'var': 'running_var'}


def params_from_jax(tree, mesh=None, split=None) -> dict:
    """{'params', 'batch_stats'} nested dicts of arrays -> state_dict of
    float32 tensors; with a mesh, this rank's shards of the tensors
    `split` names."""
    sd = {}
    for section, names in (('params', _PARAM_LEAF),
                           ('batch_stats', _STAT_LEAF)):
        for path, a in _flatten(tree.get(section) or {}):
            *mods, leaf = path
            mods = [m for m in mods if m != 'bn']
            if mods == [LOG_VARS]:
                sd[f'{LOG_VARS}.{leaf}'] = torch.from_numpy(
                    np.array(a, np.float32))
                continue
            if leaf not in names:
                raise KeyError(f"unknown leaf {'/'.join(path)}")
            a = _to_torch_layout(leaf, np.asarray(a, np.float32))
            sd['.'.join(mods + [names[leaf]])] = torch.from_numpy(
                np.ascontiguousarray(a))
    if mesh is not None and split:
        from ursonet_torch.parallel.sharding import shard_state
        sd = shard_state(sd, mesh, split)
    return sd


def params_to_jax_layout(state_dict, mesh=None, split=None) -> dict:
    """state_dict -> {'params', 'batch_stats'} nested dicts of numpy
    arrays in the JAX package's layout (the inverse of params_from_jax);
    with a mesh, the shards `split` names are gathered into the whole
    tensors first (every rank of a model group must call it)."""
    if mesh is not None and split:
        from ursonet_torch.parallel.sharding import gather_state
        state_dict = gather_state(state_dict, mesh, split)
    out = {'params': {}, 'batch_stats': {}}
    for key, t in state_dict.items():
        *mods, leaf = key.split('.')
        a = t.detach().cpu().numpy().copy()     # no view of live weights
        if mods == [LOG_VARS]:
            out['params'].setdefault(LOG_VARS, {})[leaf] = a
            continue
        is_bn = bool(mods) and is_bn_layer(mods[-1])
        if leaf in ('running_mean', 'running_var'):
            section, name = 'batch_stats', leaf[len('running_'):]
        elif is_bn:
            section, name = 'params', {'weight': 'scale', 'bias': 'bias'}[leaf]
        else:
            section = 'params'
            name = {'weight': 'kernel', 'bias': 'bias'}[leaf]
            if name == 'kernel':
                a = a.transpose(2, 3, 1, 0) if a.ndim == 4 else a.T
        node = out[section]
        for m in mods + (['bn'] if is_bn else []):
            node = node.setdefault(m, {})
        node[name] = np.ascontiguousarray(a)
    return out
