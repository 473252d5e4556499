"""Train and validation steps, the counterpart of
`ursonet_tpu/train/step.py` (`make_train_step`, `make_eval_step`).

One call of the train step runs, in order: the on-device preprocess
(augmentation with the CUDA warp kernel, pose update, PMF re-encode,
mold), the forward pass, the losses and the L2 term, the backward pass
over the trainable parameters, the global-norm clip and the Keras SGD
update. It updates the model's parameters in place and returns the
metrics dict (the loss parts of `losses.compute_losses`, 'loss' and
'l2_reg') as 0-d tensors on the device (reading them synchronises with
the card).

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
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ursonet_torch.data.loader import as_tensor
from ursonet_torch.device import check_on, resolve_device
from ursonet_torch.train import losses as L


def _model_batch(batch, preprocess, generator, dev):
    """The model batch: preprocessed from a raw batch, or an already
    molded batch (images [B,3,H,W]) moved to the device."""
    if preprocess is not None:
        b = len(batch['images_u8'])
        return preprocess(batch, preprocess.draw(generator, b))
    return {k: as_tensor(v, dev, torch.float32) for k, v in batch.items()}


def make_train_step(model, config, tx, trainable: Optional[dict] = None,
                    preprocess: Optional[Callable] = None, device="cuda"):
    """Build the train step fn(batch, generator=None) -> metrics.

    tx: `train.optim.KerasSGD`; trainable: {parameter name: bool} from
    `train.state.trainable_mask` (default: everything trains). Frozen
    parameters get requires_grad False, so autograd computes no gradient
    for them, and they are left out of the L2 term and the update.
    preprocess: `data.loader.make_device_preprocess(...)`; its draws come
    from `generator`.
    """
    dev = resolve_device(device)
    check_on(model, dev)
    if config.TRAIN_BN is not False:
        raise NotImplementedError("TRAIN_BN other than False is ported in "
                                  "a later slice")
    if trainable is None:
        trainable = {n: True for n, _ in model.named_parameters()}
    params = []
    for name, p in model.named_parameters():
        p.requires_grad_(bool(trainable[name]))
        if trainable[name]:
            params.append(p)

    def step(batch, generator: Optional[torch.Generator] = None):
        with torch.no_grad():
            batch = _model_batch(batch, preprocess, generator, dev)
        model.train()
        outputs = model(batch['images'])
        total, parts = L.compute_losses(outputs, batch, config,
                                        L.log_vars_of(model))
        reg = L.l2_regularization(model, config.WEIGHT_DECAY, trainable)
        loss = total + reg
        grads = list(torch.autograd.grad(loss, params))
        tx.step(params, grads)
        metrics = {k: v.detach() for k, v in parts.items()}
        metrics['loss'] = loss.detach()
        metrics['l2_reg'] = reg.detach()
        return metrics

    return step


def make_eval_step(model, config, preprocess: Optional[Callable] = None,
                   device="cuda"):
    """Validation step fn(batch, generator=None) -> metrics: forward and
    losses, no update (the preprocess augments, as in the JAX package)."""
    dev = resolve_device(device)
    check_on(model, dev)

    @torch.no_grad()
    def step(batch, generator: Optional[torch.Generator] = None):
        batch = _model_batch(batch, preprocess, generator, dev)
        model.eval()
        outputs = model(batch['images'])
        total, parts = L.compute_losses(outputs, batch, config,
                                        L.log_vars_of(model))
        metrics = dict(parts)
        metrics['loss'] = total
        return metrics

    return step


def _positions(i: int, steps: int, bsz: int, n_images: int,
               arange: torch.Tensor) -> torch.Tensor:
    """Dataset positions of the i-th batch of an epoch: B consecutive
    positions, wrapping around (also for a dataset smaller than B)."""
    return ((i % steps) * bsz + arange) % n_images


def make_resident_train_step(model, config, tx, n_images: int,
                             trainable: Optional[dict] = None,
                             preprocess: Optional[Callable] = None,
                             device="cuda"):
    """Train step over a device-resident dataset. Returns
    fn(data, perm, i, generator=None) -> (i + 1, metrics): `data` is
    {field: [N, ...] tensor on the device}, `perm` a permutation of N on
    the device (one an epoch, `torch.randperm(n, generator=...,
    device=...)`), `i` the step in the epoch; the batch is `data`
    gathered at perm[((i mod steps)·B + arange(B)) mod N], and the
    augmentation draws come from `generator`."""
    dev = resolve_device(device)
    step = make_train_step(model, config, tx, trainable, preprocess, dev)
    bsz = int(config.BATCH_SIZE)
    steps = max(n_images // bsz, 1)
    arange = torch.arange(bsz, device=dev)

    def resident_step(data, perm, i: int,
                      generator: Optional[torch.Generator] = None):
        idx = perm.index_select(0, _positions(i, steps, bsz, n_images,
                                              arange))
        batch = {k: v.index_select(0, idx) for k, v in data.items()}
        return i + 1, step(batch, generator)

    return resident_step


def make_resident_eval_step(model, config, n_images: int,
                            preprocess: Optional[Callable] = None,
                            device="cuda"):
    """Validation twin of make_resident_train_step: the i-th batch is
    `data` at ((i mod steps)·B + arange(B)) mod N, in order. Returns
    fn(data, i, generator=None) -> (i + 1, metrics)."""
    dev = resolve_device(device)
    step = make_eval_step(model, config, preprocess, dev)
    bsz = int(config.BATCH_SIZE)
    steps = max(n_images // bsz, 1)
    arange = torch.arange(bsz, device=dev)

    def resident_step(data, i: int,
                      generator: Optional[torch.Generator] = None):
        pos = _positions(i, steps, bsz, n_images, arange)
        batch = {k: v.index_select(0, pos) for k, v in data.items()}
        return i + 1, step(batch, generator)

    return resident_step
