"""Layer freezing and the Kendall log-variances, the counterpart of
`ursonet_tpu/train/state.py` (`LAYER_REGEX`, `layer_name_of`,
`trainable_mask`, the `loss_log_vars` of `create_train_state`).

A mask maps every parameter name of the model to True (trains) or False
(frozen: no gradient, no update, no L2 term), selected by a regex over
the Keras layer name that owns the parameter. Under
LEARNABLE_LOSS_WEIGHTS the model carries one learnable log-variance a
loss part, zero at first, as `loss_log_vars.<loss name>`: they train
with the other parameters and ride in its weights.
"""

from __future__ import annotations

import re

import torch
from torch import nn

from ursonet_torch.models.hrnet import is_hrnet

LAYER_REGEX = {
    "heads": r"(ori\_.*)|(loc\_.*)|(k\d\_.*)|(bottleneck_layer)",
    "3+": r"(res3.*)|(bn3.*)|(res4.*)|(bn4.*)|(res5.*)|(bn5.*)"
          r"|(loc\_.*)|(ori\_.*)|(k\d\_.*)|(bottleneck_layer)",
    "4+": r"(res4.*)|(bn4.*)|(res5.*)|(bn5.*)"
          r"|(loc\_.*)|(ori\_.*)|(k\d\_.*)|(bottleneck_layer)",
    "5+": r"(res5.*)|(bn5.*)|(loc\_.*)|(ori\_.*)|(k\d\_.*)|(bottleneck_layer)",
    "all": ".*",
}


def layer_name_of(name: str) -> str:
    """Keras layer name owning a parameter: 'backbone.res3a.res3a_branch2a.
    weight' -> 'res3a_branch2a'."""
    parts = name.split('.')
    return parts[-2] if len(parts) > 1 else parts[-1]


def trainable_mask(model, layers: str) -> dict:
    """{parameter name: bool}, True where the owning layer matches the
    regex (a preset name of LAYER_REGEX or a raw regex)."""
    regex = LAYER_REGEX.get(layers, layers)
    return {name: bool(re.fullmatch(regex, layer_name_of(name)))
            for name, _ in model.named_parameters()}


def loss_log_var_names(config) -> tuple:
    """The loss parts that get a learnable log-variance."""
    if is_hrnet(config.BACKBONE):
        return ('landmark_loss',)
    if config.REGRESS_KEYPOINTS:
        return ('loc_loss', 'k2_loss', 'k3_loss')
    return ('loc_loss', 'ori_loss')


def add_loss_log_vars(model: nn.Module, config) -> None:
    """Give `model` its zero log-variances as `loss_log_vars` (on the
    model's device) when config.LEARNABLE_LOSS_WEIGHTS is set."""
    if not getattr(config, 'LEARNABLE_LOSS_WEIGHTS', False):
        return
    dev = next(model.parameters()).device
    model.loss_log_vars = nn.ParameterDict({
        n: nn.Parameter(torch.zeros((), device=dev))
        for n in loss_log_var_names(config)})
