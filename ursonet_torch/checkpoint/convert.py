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
Batch-norm layers are the ones whose Keras name starts with 'bn'. The
Kendall log-variances map as they are: params/loss_log_vars/<loss> <->
loss_log_vars.<loss>, 0-d.
"""

from __future__ import annotations

import numpy as np
import torch

LOG_VARS = 'loss_log_vars'


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


def params_from_jax(tree) -> dict:
    """{'params', 'batch_stats'} nested dicts of arrays -> state_dict of
    float32 tensors."""
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
    return sd


def params_to_jax_layout(state_dict) -> dict:
    """state_dict -> {'params', 'batch_stats'} nested dicts of numpy
    arrays in the JAX package's layout (the inverse of params_from_jax)."""
    out = {'params': {}, 'batch_stats': {}}
    for key, t in state_dict.items():
        *mods, leaf = key.split('.')
        a = t.detach().cpu().numpy().copy()     # no view of live weights
        if mods == [LOG_VARS]:
            out['params'].setdefault(LOG_VARS, {})[leaf] = a
            continue
        is_bn = bool(mods) and mods[-1].startswith('bn')
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
