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
        total, parts = L.compute_losses(outputs, batch, config)
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
        total, parts = L.compute_losses(outputs, batch, config)
        metrics = dict(parts)
        metrics['loss'] = total
        return metrics

    return step
