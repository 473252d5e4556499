"""Train and validation steps, the counterpart of
`ursonet_tpu/train/step.py` (`make_train_step`, `make_eval_step`).

One call of the train step runs, in order: the on-device preprocess
(augmentation with the CUDA warp kernel, pose update, PMF re-encode,
mold), the forward pass, the losses and the L2 term, the backward pass
over the trainable parameters, the global-norm clip and the Keras SGD
update. It updates the model's parameters in place and returns the
metrics dict (the loss parts of `losses.compute_losses`, 'loss' and
'l2_reg') as 0-d tensors on the device (reading them synchronises with
the card). Spans (`utils/profiling.py`): ursonet.train.step around a
step, holding .preprocess, .forward, .backward and .update; the
resident step's gather in ursonet.train.gather.

Under F16 the forward and its backward compute in bf16 (the model's
casts, `models/resnet.py`), while the parameters, their gradients, the
losses, the L2 term, the clip and the update stay f32, as in the JAX
step. There is no loss scaling: the JAX step has none, and bf16 keeps
f32's exponent range.

The resident steps (`make_resident_train_step`,
`make_resident_eval_step`) take their batch from a dataset loaded onto
the device (`data/loader.py::load_dataset_resident`) by an index gather
on the device: no host-to-device copy per step. Under
LEARNABLE_LOSS_WEIGHTS the model's `loss_log_vars` weight the losses
(`losses.compute_losses`) and train with the other parameters.

Over a (data, model) mesh (`parallel/`, `mesh=`) each rank's step takes
its rows of the global batch. It draws the global batch's augmentation
from the shared generator and keeps its rows
(`parallel/sharding.py::slice_draws`), so each rank's `warp_mold` warps
its own rows with the single-process draws; the losses are the global
batch's (`losses.compute_losses(red=...)`); after
`torch.autograd.grad` the gradients are summed over 'data' as one flat
bucket (`all_reduce_bucket`: one all-reduce a step, also over a group of
one); the clip and the L2 term count a head shard as its share of the
whole tensor. The resident steps draw one permutation on every rank and
gather the rank's rows of each global batch. A mesh of one rank
computes the single-process step's bits.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ursonet_torch.data.loader import as_tensor
from ursonet_torch.device import check_on, resolve_device
from ursonet_torch.models.resnet import commit_batch_stats
from ursonet_torch.parallel.mesh import AXIS_DATA, AXIS_MODEL
from ursonet_torch.parallel.multihost import local_batch_slice
from ursonet_torch.parallel.sharding import all_reduce_bucket, \
    data_reduce, model_split, scale_grad, slice_draws
from ursonet_torch.train import losses as L
from ursonet_torch.utils.profiling import span


def _model_batch(batch, preprocess, generator, dev, rows=None):
    """The model batch: preprocessed from a raw batch, or an already
    molded batch (images [B,3,H,W]) moved to the device. rows (lo, hi,
    global batch): `batch` holds rows [lo, hi) of a global batch, whose
    draws are made whole and sliced."""
    if preprocess is not None:
        if rows is None:
            b = len(batch['images_u8'])
            return preprocess(batch, preprocess.draw(generator, b))
        lo, hi, b = rows
        if len(batch['images_u8']) != hi - lo:
            raise ValueError(f"the rank's batch holds "
                             f"{len(batch['images_u8'])} rows, its slice "
                             f"{hi - lo}")
        return preprocess(batch, slice_draws(preprocess.draw(generator, b),
                                             lo, hi))
    return {k: as_tensor(v, dev, torch.float32) for k, v in batch.items()}


def _rows(mesh, config):
    """(lo, hi, global batch) of this rank under a mesh that splits
    'data', else None (the batch is the whole one)."""
    if mesh is None or mesh.shape[AXIS_DATA] == 1:
        return None
    bsz = int(config.BATCH_SIZE)
    return local_batch_slice(mesh, bsz) + (bsz,)


def make_train_step(model, config, tx, trainable: Optional[dict] = None,
                    preprocess: Optional[Callable] = None, device="cuda",
                    mesh=None):
    """Build the train step fn(batch, generator=None) -> metrics.

    tx: `train.optim.KerasSGD`; trainable: {parameter name: bool} from
    `train.state.trainable_mask` (default: everything trains). Frozen
    parameters get requires_grad False, so autograd computes no gradient
    for them, and they are left out of the L2 term and the update.
    Under TRAIN_BN None or True the batch norms normalize with the
    batch's statistics, and each one's running statistics take the
    step's update once, after the backward pass (`commit_batch_stats`):
    every batch norm's, also where `trainable` freezes its parameters, as
    the JAX step makes all of batch_stats mutable.
    preprocess: `data.loader.make_device_preprocess(...)`; its draws come
    from `generator`. mesh: the (data, model) mesh `model` was sharded
    over (`parallel.shard_model`); the batch is then this rank's rows.
    """
    dev = resolve_device(device)
    check_on(model, dev)
    update_bn = config.TRAIN_BN is None or config.TRAIN_BN is True
    if trainable is None:
        trainable = {n: True for n, _ in model.named_parameters()}
    params, names = [], []
    for name, p in model.named_parameters():
        p.requires_grad_(bool(trainable[name]))
        if trainable[name]:
            params.append(p)
            names.append(name)
    rows = _rows(mesh, config)
    red = data_reduce(mesh)
    data_group = None if mesh is None else mesh.group(AXIS_DATA)
    model_group = None if mesh is None else mesh.split(AXIS_MODEL)
    split = model_split(model)
    sharded = [n in split for n in names]

    def step(batch, generator: Optional[torch.Generator] = None):
        with span('ursonet.train.step'):
            with span('ursonet.train.preprocess'), torch.no_grad():
                batch = _model_batch(batch, preprocess, generator, dev, rows)
            with span('ursonet.train.forward'):
                model.train()
                outputs = model(batch['images'])
                total, parts = L.compute_losses(outputs, batch, config,
                                                L.log_vars_of(model), red)
                reg = L.l2_regularization(model, config.WEIGHT_DECAY,
                                          trainable, split, model_group)
                if red is not None:
                    # every data rank computes the L2 term's whole
                    # gradient
                    reg = scale_grad(reg, 1.0 / red.size)
                loss = total + reg
            with span('ursonet.train.backward'):
                grads = list(torch.autograd.grad(loss, params))
                if data_group is not None:
                    all_reduce_bucket(grads, data_group)
            with span('ursonet.train.update'):
                tx.step(params, grads, sharded, model_group)
                if update_bn:
                    commit_batch_stats(model)
                metrics = {k: v.detach() for k, v in parts.items()}
                metrics['loss'] = loss.detach()
                metrics['l2_reg'] = reg.detach()
            return metrics

    return step


def make_eval_step(model, config, preprocess: Optional[Callable] = None,
                   device="cuda", mesh=None):
    """Validation step fn(batch, generator=None) -> metrics: forward and
    losses in eval mode (batch norm on its running statistics), no
    update (the preprocess augments, as in the JAX package). Under a
    mesh the batch is this rank's rows and the metrics the global
    batch's."""
    dev = resolve_device(device)
    check_on(model, dev)
    rows = _rows(mesh, config)
    red = data_reduce(mesh)

    @torch.no_grad()
    def step(batch, generator: Optional[torch.Generator] = None):
        batch = _model_batch(batch, preprocess, generator, dev, rows)
        model.eval()
        outputs = model(batch['images'])
        total, parts = L.compute_losses(outputs, batch, config,
                                        L.log_vars_of(model), red)
        metrics = dict(parts)
        metrics['loss'] = total
        return metrics

    return step


def check_nans(where: str, metrics: dict, model=None) -> None:
    """DEBUG_NANS, the counterpart of the JAX package's jax_debug_nans:
    raise FloatingPointError naming `where` and the tensors when the
    step's metrics, or `model`'s parameters and buffers after its update,
    hold a NaN. One host sync."""
    named = list(metrics.items())
    if model is not None:
        named += list(model.named_parameters()) + list(model.named_buffers())
    flags = torch.stack([torch.isnan(v).any() for _, v in named]).tolist()
    bad = [name for (name, _), f in zip(named, flags) if f]
    if bad:
        raise FloatingPointError(
            f"NaN at {where} (DEBUG_NANS) in {len(bad)} tensors: "
            + ", ".join(bad[:8]) + (", ..." if len(bad) > 8 else ""))


def _positions(i: int, steps: int, bsz: int, n_images: int,
               arange: torch.Tensor) -> torch.Tensor:
    """Dataset positions of the i-th batch of an epoch: B consecutive
    positions, wrapping around (also for a dataset smaller than B);
    `arange` the rows of the batch to take (all, or a rank's)."""
    return ((i % steps) * bsz + arange) % n_images


def _local_arange(mesh, config, dev) -> torch.Tensor:
    """The rows of each global batch this rank gathers."""
    rows = _rows(mesh, config)
    lo, hi = (0, int(config.BATCH_SIZE)) if rows is None else rows[:2]
    return torch.arange(lo, hi, device=dev)


def make_resident_train_step(model, config, tx, n_images: int,
                             trainable: Optional[dict] = None,
                             preprocess: Optional[Callable] = None,
                             device="cuda", mesh=None):
    """Train step over a device-resident dataset. Returns
    fn(data, perm, i, generator=None) -> (i + 1, metrics): `data` is
    {field: [N, ...] tensor on the device}, `perm` a permutation of N on
    the device (one an epoch, `torch.randperm(n, generator=...,
    device=...)`), `i` the step in the epoch; the batch is `data`
    gathered at perm[((i mod steps)·B + arange(B)) mod N], and the
    augmentation draws come from `generator`. Under a mesh every rank
    holds the whole dataset and the same permutation, and gathers its
    rows of the global batch."""
    dev = resolve_device(device)
    step = make_train_step(model, config, tx, trainable, preprocess, dev,
                           mesh)
    bsz = int(config.BATCH_SIZE)
    steps = max(n_images // bsz, 1)
    arange = _local_arange(mesh, config, dev)

    def resident_step(data, perm, i: int,
                      generator: Optional[torch.Generator] = None):
        with span('ursonet.train.gather'):
            idx = perm.index_select(0, _positions(i, steps, bsz, n_images,
                                                  arange))
            batch = {k: v.index_select(0, idx) for k, v in data.items()}
        return i + 1, step(batch, generator)

    return resident_step


def make_resident_eval_step(model, config, n_images: int,
                            preprocess: Optional[Callable] = None,
                            device="cuda", mesh=None):
    """Validation twin of make_resident_train_step: the i-th batch is
    `data` at ((i mod steps)·B + arange(B)) mod N, in order. Returns
    fn(data, i, generator=None) -> (i + 1, metrics)."""
    dev = resolve_device(device)
    step = make_eval_step(model, config, preprocess, dev, mesh)
    bsz = int(config.BATCH_SIZE)
    steps = max(n_images // bsz, 1)
    arange = _local_arange(mesh, config, dev)

    def resident_step(data, i: int,
                      generator: Optional[torch.Generator] = None):
        pos = _positions(i, steps, bsz, n_images, arange)
        batch = {k: v.index_select(0, pos) for k, v in data.items()}
        return i + 1, step(batch, generator)

    return resident_step
