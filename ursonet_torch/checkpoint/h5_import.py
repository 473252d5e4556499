"""Keras-HDF5 weights in and out of the port's models: the port of
`ursonet_tpu/checkpoint/h5_import.py`, on the port's own HDF5 codec
(`checkpoint/hdf5.py`) instead of h5py.

Loads reference-format weight files (the released UrsoNet models, the
Keras ImageNet ResNets, the COCO Mask-RCNN file) into a model's
`state_dict` by layer name, with layer exclusion: the Keras
`load_weights(by_name=True, exclude=...)` contract.

Keras keeps conv kernels as (kh, kw, in, out) and dense kernels as
(in, out), the JAX package's layout; the port converts its `state_dict`
to that layout and back (`checkpoint/convert.py`), so the name matching,
the report and the file layout are the JAX package's, key for key:
  * conv / dense layers: `kernel`, `bias`;
  * batch norm: `gamma`, `beta`, `moving_mean`, `moving_variance`
    (`_BN_MAP`);
  * a reference 7×7 stem kernel loads into an s2d (4×4, 4C) stem
    exactly (`models/resnet.stem_kernel_to_s2d`).
"""

from __future__ import annotations

import hashlib
import os
import re
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from ursonet_torch.checkpoint import hdf5
from ursonet_torch.checkpoint.convert import params_from_jax, \
    params_to_jax_layout

_BN_MAP = {
    'gamma': ('params', 'scale'),
    'beta': ('params', 'bias'),
    'moving_mean': ('batch_stats', 'mean'),
    'moving_variance': ('batch_stats', 'var'),
}


def _text(n) -> str:
    return n.decode() if isinstance(n, bytes) else str(n)


def _iter_keras_weights(h5file):
    """Yield (layer_name, weight_name, np.ndarray) from a Keras weights
    file (plain and nested 'model_weights' layouts)."""
    root = h5file['model_weights'] if 'model_weights' in h5file else h5file
    layer_names = [_text(n) for n in
                   root.attrs.get('layer_names', list(root.keys()))]
    for lname in layer_names:
        if lname not in root:
            continue
        g = root[lname]
        wnames = [_text(n) for n in g.attrs.get('weight_names', [])]
        if not wnames:  # fall back to walking the group
            def walk(grp, prefix=''):
                for k, v in grp.items():
                    if isinstance(v, hdf5.Dataset):
                        yield prefix + k, np.asarray(v)
                    else:
                        yield from walk(v, prefix + k + '/')
            for wname, arr in walk(g):
                yield lname, wname, arr
        else:
            for wname in wnames:
                yield lname, wname, np.asarray(g[wname])


def index_layers(params) -> Dict[str, Tuple[str, ...]]:
    """Map layer name -> path of its sub-dict in a JAX-layout tree (layers
    sit at different depths: backbone blocks, heads, the bottleneck)."""
    out: Dict[str, Tuple[str, ...]] = {}

    def visit(node, path):
        if not isinstance(node, dict):
            return
        for k, v in node.items():
            if isinstance(v, dict):
                leaf_children = any(not isinstance(c, dict)
                                    for c in v.values())
                if leaf_children or 'bn' in v:
                    out.setdefault(k, path + (k,))
                visit(v, path + (k,))

    visit(params, ())
    return out


def _assign(tree, path, arr) -> bool:
    node = tree
    for k in path[:-1]:
        if not isinstance(node, dict) or k not in node:
            return False
        node = node[k]
    leaf = path[-1]
    if not isinstance(node, dict) or leaf not in node:
        return False
    cur = node[leaf]
    if tuple(np.shape(cur)) != tuple(np.shape(arr)):
        # a reference (7,7,C,O) stem kernel maps exactly onto the
        # (4,4,4C,O) space-to-depth stem
        if (np.ndim(arr) == 4 and np.shape(arr)[:2] == (7, 7)
                and tuple(np.shape(cur)) ==
                (4, 4, 4 * np.shape(arr)[2], np.shape(arr)[3])):
            from ursonet_torch.models.resnet import stem_kernel_to_s2d
            arr = stem_kernel_to_s2d(np.asarray(arr))
        else:
            return False
    node[leaf] = np.asarray(arr, dtype=np.asarray(cur).dtype)
    return True


def load_keras_h5(path: str, state_dict, exclude: Sequence[str] = (),
                  verbose: bool = False):
    """Merge a Keras h5 weight file into a model's `state_dict` by layer
    name. Returns (new state_dict of CPU tensors, report), the report
    listing 'loaded', 'excluded' (a layer name fully matching a regex of
    `exclude`), 'unmatched' (no such layer or leaf: skipped, like Keras
    by-name loading) and 'mismatched' (another shape) as 'layer/leaf'
    strings, in file order."""
    tree = params_to_jax_layout(state_dict)
    params = tree['params']
    batch_stats = tree['batch_stats'] or None
    layer_index = index_layers(params)
    loaded, excluded, unmatched, mismatched = [], [], [], []

    def is_excluded(name: str) -> bool:
        return any(re.fullmatch(pat, name) for pat in exclude)

    with hdf5.File(path) as f:
        for lname, wname, arr in _iter_keras_weights(f):
            leaf = wname.split('/')[-1].split(':')[0]
            if lname not in layer_index:
                unmatched.append(f"{lname}/{leaf}")
                continue
            if is_excluded(lname):
                excluded.append(f"{lname}/{leaf}")
                continue
            ppath = layer_index[lname]
            if leaf in ('kernel', 'bias'):
                ok = _assign(params, ppath + (leaf,), arr)
            elif leaf in _BN_MAP:
                coll, newleaf = _BN_MAP[leaf]
                target = params if coll == 'params' else batch_stats
                if target is None:
                    continue
                ok = _assign(target, ppath + ('bn', newleaf), arr)
            else:
                unmatched.append(f"{lname}/{leaf}")
                continue
            (loaded if ok else mismatched).append(f"{lname}/{leaf}")

    report = {'loaded': loaded, 'excluded': excluded,
              'unmatched': unmatched, 'mismatched': mismatched}
    if verbose:
        print(f"h5 import: {len(loaded)} loaded, {len(excluded)} excluded, "
              f"{len(unmatched)} unmatched, {len(mismatched)} "
              "shape-mismatched")
    merged = params_from_jax({'params': params, 'batch_stats': batch_stats})
    return {name: merged[name].to(cur.dtype)
            for name, cur in state_dict.items()}, report


def save_keras_h5(path: str, state_dict):
    """Export a model's `state_dict` as a reference-layout Keras weights
    file, the inverse of `load_keras_h5` (readable by the JAX package's
    and Keras's by-name loading): one group per layer with a
    `weight_names` attribute, conv / dense -> kernel, bias; batch norm ->
    gamma, beta, moving_mean, moving_variance; the root's `layer_names`.
    An s2d stem kernel (4,4,4C,O) is written as it is."""
    tree = params_to_jax_layout(state_dict)
    params, batch_stats = tree['params'], tree['batch_stats']
    layer_index = index_layers(params)
    stats_index = index_layers(batch_stats)

    def get(tree, pth):
        node = tree
        for k in pth:
            node = node[k]
        return node

    with hdf5.File(path, 'w') as f:
        layer_names = []
        for lname, ppath in sorted(layer_index.items()):
            if lname == 'bn':  # the inner batch-norm level, not a layer
                continue
            node = get(params, ppath)
            weights = {}
            if 'bn' in node:
                bn = node['bn']
                weights['gamma'] = bn['scale']
                weights['beta'] = bn['bias']
                spath = stats_index.get(lname)
                if spath is not None:
                    sbn = get(batch_stats, spath)['bn']
                    weights['moving_mean'] = sbn['mean']
                    weights['moving_variance'] = sbn['var']
            else:
                for leaf in ('kernel', 'bias'):
                    if leaf in node and not isinstance(node[leaf], dict):
                        weights[leaf] = node[leaf]
            if not weights:
                continue
            g = f.create_group(lname)
            wnames = []
            for leaf, arr in weights.items():
                wname = f"{lname}/{leaf}:0"
                g.create_dataset(wname, data=np.asarray(arr, np.float32))
                wnames.append(wname.encode())
            g.attrs['weight_names'] = wnames
            layer_names.append(lname.encode())
        f.attrs['layer_names'] = layer_names
    return path


# Released-weights config assertions (reference net.py:886-940).
RELEASED_CONFIGS = {
    'soyuz_hard': dict(BACKBONE='resnet50', BOTTLENECK_WIDTH=128,
                       ORI_BINS_PER_DIM=24, REGRESS_ORI=False),
    'dragon_hard': dict(BACKBONE='resnet50', BOTTLENECK_WIDTH=128,
                        ORI_BINS_PER_DIM=24, REGRESS_ORI=False),
    'speed': dict(BACKBONE='resnet101', REGRESS_ORI=False),
}


def check_released_config(name: str, config) -> Optional[str]:
    """An error string if `config` cannot hold the named released model
    (reference net.py:897-931), else None."""
    want = RELEASED_CONFIGS.get(name)
    if not want:
        return None
    for k, v in want.items():
        if getattr(config, k) != v:
            return f"released model '{name}' requires {k}={v}"
    if name == 'speed' and (config.BOTTLENECK_WIDTH, config.ORI_BINS_PER_DIM) \
            not in ((528, 32), (800, 64)):
        return ("released model 'speed' requires bottleneck/bins "
                "528/32 or 800/64")
    return None


# Canonical file names as the reference downloads them (net.py:854-940),
# with the md5s it pins (net.py:861-883); the UrsoNet release files
# publish none.
RELEASED_FILES = {
    'soyuz_hard': ('resnet50_soyuz_hard_128_24.h5', None),
    'dragon_hard': ('resnet50_dragon_hard_128_24.h5', None),
    'speed_528_32': ('resnet101_speed_528_32.h5', None),
    'speed_800_64': ('resnet101_speed_800_64.h5', None),
    'coco': ('mask_rcnn_coco.h5', None),
    'imagenet_resnet50': (
        'resnet50_weights_tf_dim_ordering_tf_kernels_notop.h5',
        'a268eb855778b3df3c7506639542a6af'),
    'imagenet_resnet101': (  # the reference reuses the resnet50 file
        'resnet50_weights_tf_dim_ordering_tf_kernels_notop.h5',
        'a268eb855778b3df3c7506639542a6af'),
    'imagenet_resnet18': ('resnet18_imagenet_1000_no_top.h5',
                          '318e3ac0cd98d51e917526c9f62f0b50'),
    'imagenet_resnet34': ('resnet34_imagenet_1000_no_top.h5',
                          '8caaa0ad39d927cb8ba5385bf945d582'),
}


def find_released_file(models_dir: str, key: str) -> Optional[str]:
    """A released file under `models_dir` by its canonical reference
    name, or by the short alias (ursonet_<name>.h5 / imagenet_<backbone>
    .h5); None if absent."""
    canonical, _ = RELEASED_FILES.get(key, (None, None))
    candidates = []
    if canonical:
        candidates.append(canonical)
    if key.startswith('imagenet_'):
        candidates.append(f'{key}.h5')
    elif key != 'coco':
        candidates.append(f'ursonet_{key}.h5')
    for fn in candidates:
        path = os.path.join(models_dir, fn)
        if os.path.exists(path):
            return path
    return None


def file_md5(path: str) -> str:
    h = hashlib.md5()
    with open(path, 'rb') as f:
        for chunk in iter(lambda: f.read(1 << 20), b''):
            h.update(chunk)
    return h.hexdigest()


def released_md5_error(key: str, path: str) -> Optional[str]:
    """An error string if the md5 the reference pins for `key` differs
    from `path`'s, else None (also where none is pinned)."""
    _, want = RELEASED_FILES.get(key, (None, None))
    if not want:
        return None
    got = file_md5(path)
    return None if got == want else f"{path}: md5 {got} != {want}"
