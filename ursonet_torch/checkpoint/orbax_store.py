"""Orbax checkpoint directories (CHECKPOINT_FORMAT='orbax'), the
counterpart of `ursonet_tpu/checkpoint/orbax_store.py`, read and written
without orbax or tensorstore.

Each snapshot is a directory, `weights_{name}_{epoch:04d}.orbax/` or
`state_latest.orbax/`, in the layout Orbax's `StandardCheckpointer`
writes: `_METADATA` (every leaf's key path and value type),
`_CHECKPOINT_METADATA`, and an OCDBT database (`checkpoint/ocdbt.py`)
holding one zarr v2 array per leaf (`checkpoint/zarr.py`), named by its
dotted key path (`params.bn_conv1.bn.scale`). The trees are nested numpy
dicts in the JAX package's layout (`checkpoint/store.py` converts them to
and from the port's tensors):

    weights  {'params', 'batch_stats'}
    state    {'meta': {'step', 'epoch'}, 'params', 'batch_stats',
              'opt_state'}

An empty `batch_stats` is stored as an empty dict and loads as None. A
save writes into a sibling directory and renames it into place, so an
interrupted save leaves the old snapshot whole. Reading follows the key
paths `_METADATA` lists (the opt_state trees of SGD, Adam and Adam + CLR
differ); a directory without OCDBT (`use_ocdbt: false`) or with zarr v3
arrays raises ValueError.
"""

from __future__ import annotations

import json
import os
import shutil
import time
from typing import Any, Dict, Optional

import numpy as np

from ursonet_torch.checkpoint import ocdbt, zarr

ORBAX_SUFFIX = '.orbax'
METADATA = '_METADATA'
CHECKPOINT_METADATA = '_CHECKPOINT_METADATA'
_HANDLER = ('orbax.checkpoint._src.handlers.standard_checkpoint_handler.'
            'StandardCheckpointHandler')
_DICT_KEY = 2   # orbax's KeyType.DICT


def _leaves(tree, prefix=()):
    """(key path, leaf) in sorted key order, an empty dict as a leaf."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict) and v:
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _write_tree(path: str, tree: dict) -> None:
    path = os.path.abspath(path)
    t0 = time.time_ns()
    tmp = f'{path}.orbax-checkpoint-tmp-{t0}'
    os.makedirs(tmp)
    try:
        _write_dir(tmp, tree, t0)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    if os.path.exists(path):
        old = f'{path}.orbax-checkpoint-old-{t0}'
        os.rename(path, old)
        os.rename(tmp, path)
        shutil.rmtree(old)
    else:
        os.rename(tmp, path)


def _write_dir(root: str, tree: dict, t0: int) -> None:
    items, meta = {}, {}
    for keys, leaf in _leaves(tree):
        if isinstance(leaf, dict):
            value = {'value_type': 'Dict', 'skip_deserialize': True}
        else:
            scalar = isinstance(leaf, (int, float)) \
                and not isinstance(leaf, bool)
            items.update(zarr.array_items('.'.join(keys), np.asarray(leaf)))
            value = {'value_type': 'scalar' if scalar else 'np.ndarray',
                     'skip_deserialize': False}
        meta[str(tuple(keys))] = {
            'key_metadata': [{'key': k, 'key_type': _DICT_KEY} for k in keys],
            'value_metadata': value}
    ocdbt.write_db(root, items)
    with open(os.path.join(root, METADATA), 'w') as f:
        json.dump({'tree_metadata': meta, 'use_ocdbt': True,
                   'use_zarr3': False,
                   'store_array_data_equal_to_fill_value': True,
                   'custom_metadata': None}, f)
    with open(os.path.join(root, CHECKPOINT_METADATA), 'w') as f:
        json.dump({'item_handlers': _HANDLER, 'metrics': {},
                   'performance_metrics': {}, 'init_timestamp_nsecs': t0,
                   'commit_timestamp_nsecs': time.time_ns(),
                   'custom_metadata': {}}, f)


def _read_tree(path: str) -> dict:
    with open(os.path.join(path, METADATA)) as f:
        meta = json.load(f)
    if meta.get('use_zarr3') or not meta.get('use_ocdbt'):
        raise ValueError(f'{path}: only OCDBT directories of zarr v2 arrays '
                         'are supported')
    get = ocdbt.Database(path).get
    tree: Dict[str, Any] = {}
    for name, entry in meta['tree_metadata'].items():
        keys = []
        for k in entry['key_metadata']:
            if k['key_type'] != _DICT_KEY:
                raise ValueError(f'{path}: {name} has a sequence key; the '
                                 'store reads dict trees')
            keys.append(k['key'])
        kind = entry['value_metadata']['value_type']
        if kind == 'Dict':      # an empty dict, stored as no array
            leaf = {}
        else:
            leaf = zarr.read_array(get, '.'.join(keys))
            if kind == 'scalar':
                leaf = leaf.item()
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = leaf
    return tree


def save_weights_dir(path: str, params: dict,
                     batch_stats: Optional[dict] = None) -> None:
    """Save {'params', 'batch_stats'} as an Orbax checkpoint directory."""
    _write_tree(path, {'params': params, 'batch_stats': batch_stats or {}})


def load_weights_dir(path: str) -> Dict[str, Any]:
    tree = _read_tree(os.path.abspath(path))
    if not tree.get('batch_stats'):
        tree['batch_stats'] = None
    return tree


def save_state_dir(path: str, state: dict) -> None:
    """Full train state, {'step', 'epoch', 'params', 'batch_stats',
    'opt_state'} (the msgpack state's tree), for an exact resume."""
    _write_tree(path, {
        'meta': {'step': int(state['step']), 'epoch': int(state['epoch'])},
        'params': state['params'],
        'batch_stats': state.get('batch_stats') or {},
        'opt_state': state['opt_state']})


def load_state_dir(path: str) -> Dict[str, Any]:
    tree = _read_tree(os.path.abspath(path))
    return {'step': int(tree['meta']['step']),
            'epoch': int(tree['meta']['epoch']),
            'params': tree['params'],
            'batch_stats': tree.get('batch_stats') or None,
            'opt_state': tree['opt_state']}


def is_orbax_path(path: Optional[str]) -> bool:
    return bool(path) and path.rstrip('/\\').endswith(ORBAX_SUFFIX)
