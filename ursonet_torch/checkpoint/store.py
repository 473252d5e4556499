"""Weight and train-state snapshots with the run-dir contract, the
counterpart of `ursonet_tpu/checkpoint/store.py`.

  * run dir `{name.lower()}{YYYYMMDDTHHMM}` inside the model dir;
  * per-epoch weight snapshot `weights_{name.lower()}_{epoch:04d}.msgpack`;
  * `find_last` takes the newest run dir and snapshot by name order, and
    a snapshot's path gives back its run dir and the epoch after it;
  * by-name partial loading with layer exclusion (`merge_params`).

Files are written atomically (a temporary file, then a rename) in the
JAX package's own msgpack layout (`checkpoint/msgpack.py`), so each
package loads and resumes the other's:

  weights  {'params': tree, 'batch_stats': tree}
  state    {'step', 'epoch', 'params', 'batch_stats',
            'opt_state': {'0': {}, '1': {'count', 'velocity': tree}}}

with the trees in the JAX layout (`checkpoint/convert.py`). 'opt_state'
is flax's `to_state_dict` of the JAX optimizer chain: the global-norm
clip (no state), then `KerasSGDState(velocity, count)`, whose velocity
is `KerasSGD.velocity` (v <- m·v - lr·g) for every parameter, zero for
those that never trained.
"""

from __future__ import annotations

import datetime
import os
import re
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ursonet_torch.checkpoint.convert import params_from_jax, \
    params_to_jax_layout
from ursonet_torch.checkpoint.msgpack import msgpack_restore, \
    msgpack_serialize
from ursonet_torch.train.state import layer_name_of

WEIGHTS_EXT = '.msgpack'


# ---------------------------------------------------------------------------
# run dirs


def set_log_dir(model_dir: str, name: str,
                weights_path: Optional[str] = None,
                now: Optional[datetime.datetime] = None,
                ext: str = WEIGHTS_EXT) -> Tuple[str, str, int]:
    """(log_dir, checkpoint template, first epoch). A snapshot path of a
    run dir gives that run dir and the epoch after the snapshot's."""
    now = now or datetime.datetime.now()
    epoch = 0
    log_dir = os.path.join(model_dir, f"{name.lower()}{now:%Y%m%dT%H%M}")
    if weights_path:
        m = re.match(
            r".*[/\\][\w\-]+(\d{4}T\d{4})[/\\]weights\_[\w\-]+\_(\d{4})\."
            r"(h5|msgpack|orbax)", weights_path)
        if m:
            log_dir = os.path.dirname(weights_path)
            epoch = int(m.group(2)) + 1
    template = os.path.join(log_dir, f"weights_{name.lower()}_*epoch*{ext}")
    return log_dir, template, epoch


def checkpoint_epoch(template: str, epoch: int) -> str:
    return template.replace("*epoch*", f"{epoch:04d}")


def _run_dirs(model_dir: str, name_prefix: Optional[str] = None):
    if not os.path.isdir(model_dir):
        return []
    names = sorted(os.listdir(model_dir))
    if name_prefix:
        names = [n for n in names if n.startswith(name_prefix.lower())]
    return [n for n in names if os.path.isdir(os.path.join(model_dir, n))]


def latest_in_dir(run_dir: str) -> Optional[str]:
    """Newest weight snapshot inside one run dir."""
    if not os.path.isdir(run_dir):
        return None
    cands = sorted(f for f in os.listdir(run_dir)
                   if f.startswith("weights_")
                   and (f.endswith(WEIGHTS_EXT) or f.endswith('.orbax')))
    return os.path.join(run_dir, cands[-1]) if cands else None


def find_last(model_dir: str) -> str:
    """Newest snapshot of the newest run dir; FileNotFoundError if none."""
    for d in reversed(_run_dirs(model_dir)):
        ckpt = latest_in_dir(os.path.join(model_dir, d))
        if ckpt:
            return ckpt
    raise FileNotFoundError(f"Could not find weight files in {model_dir}")


def get_last_checkpoint(model_dir: str, model_name: str) -> str:
    """Newest snapshot among the run dirs named after `model_name`."""
    for d in reversed(_run_dirs(model_dir, model_name)):
        ckpt = latest_in_dir(os.path.join(model_dir, d))
        if ckpt:
            return ckpt
    raise FileNotFoundError(
        f"Could not find weight files for {model_name} in {model_dir}")


# ---------------------------------------------------------------------------
# files


def _atomic_write(path: str, payload: bytes) -> None:
    os.makedirs(os.path.dirname(path) or '.', exist_ok=True)
    tmp = path + '.tmp'
    with open(tmp, 'wb') as f:
        f.write(payload)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _read(path: str) -> dict:
    with open(path, 'rb') as f:
        tree = msgpack_restore(f.read())
    if not tree.get('batch_stats'):
        tree['batch_stats'] = None
    return tree


def save_weights_file(path: str, state_dict) -> None:
    """Atomic weight snapshot of a model's state_dict."""
    _atomic_write(path, msgpack_serialize(params_to_jax_layout(state_dict)))


def load_weights_file(path: str) -> Dict[str, torch.Tensor]:
    """A weight snapshot (of either package) as a state_dict of f32
    tensors on the CPU."""
    return params_from_jax(_read(path))


def velocity_tree(model, velocity: Dict[str, torch.Tensor]) -> dict:
    """The velocity of every parameter of `model` in the JAX params
    layout: `velocity[name]` where the optimizer has one, else zeros."""
    sd = {n: velocity[n] if n in velocity else torch.zeros_like(p)
          for n, p in model.named_parameters()}
    return params_to_jax_layout(sd)['params']


def save_state(path: str, model, velocity: Dict[str, torch.Tensor],
               step: int, epoch: int) -> None:
    """Atomic full train-state snapshot for an exact resume: weights,
    the optimizer's velocity by parameter name and its update count."""
    tree = params_to_jax_layout(model.state_dict())
    tree.update({
        'step': int(step), 'epoch': int(epoch),
        'opt_state': {'0': {}, '1': {
            'count': np.asarray(step, np.int32),
            'velocity': velocity_tree(model, velocity)}},
    })
    _atomic_write(path, msgpack_serialize(tree))


def load_state(path: str) -> dict:
    """A train-state snapshot (of either package): {'state_dict',
    'velocity' (by parameter name), 'step', 'epoch'}, tensors f32 on the
    CPU."""
    tree = _read(path)
    velocity = params_from_jax(
        {'params': tree['opt_state']['1']['velocity']})
    return {'state_dict': params_from_jax(tree), 'velocity': velocity,
            'step': int(tree['step']), 'epoch': int(tree['epoch'])}


# ---------------------------------------------------------------------------
# by-name partial loading


def merge_params(current, incoming, exclude: Sequence[str] = ()):
    """Merge the state_dict `incoming` into `current` by name, skipping
    layers whose Keras name fully matches a regex of `exclude` and
    tensors whose shape differs. Returns (merged, loaded layer names,
    skipped layer names)."""
    exclude = list(exclude or ())
    loaded, skipped = set(), set()
    merged = {}
    for name, cur in current.items():
        layer = layer_name_of(name)
        inc = incoming.get(name)
        if inc is not None and not any(re.fullmatch(p, layer)
                                       for p in exclude) \
                and tuple(inc.shape) == tuple(cur.shape):
            merged[name] = inc.to(cur.dtype)
            loaded.add(layer)
        else:
            merged[name] = cur
            if inc is not None:
                skipped.add(layer)
    return merged, sorted(loaded), sorted(skipped)
