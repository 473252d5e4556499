"""BatchNorm folding for inference (the port's copy of
`ursonet_tpu/models/folding.py`), on nested dicts of numpy arrays in the
JAX package's layout (`checkpoint/convert.py::params_to_jax_layout`).

Folds frozen BatchNorm (running statistics, TRAIN_BN=False) into the
preceding convolution:

    W' = W · γ/√(σ²+ε)   (per output channel)
    b' = β + (b − μ) · γ/√(σ²+ε)

and neutralizes the BN parameters (γ=1, β=0, μ=0, σ²=1−ε), so the same
graph computes the same function with the BN reduced to a no-op.

Conv→BN name pairing follows the Keras layer names:
  conv1→bn_conv1, conv0→bn_conv0 (stems),
  res{S}{b}_branch{X}→bn{S}{b}_branch{X} (bottleneck blocks),
  stage{S}_unit{U}_conv1→stage{S}_unit{U}_bn2 (basic blocks).
"""

from __future__ import annotations

import re
from typing import Tuple

import numpy as np

from ursonet_torch.models.resnet import BN_EPS


def _bn_name_for(conv_name: str):
    if conv_name in ('conv1', 'conv0'):
        return f'bn_{conv_name}'
    m = re.fullmatch(r'res(\w+)_branch(\w+)', conv_name)
    if m:
        return f'bn{m.group(1)}_branch{m.group(2)}'
    m = re.fullmatch(r'(stage\d+_unit\d+_)conv1', conv_name)
    if m:
        return f'{m.group(1)}bn2'
    return None


def _copy(tree):
    if isinstance(tree, dict):
        return {k: _copy(v) for k, v in tree.items()}
    return np.array(tree, copy=True)


def fold_bn(params, batch_stats) -> Tuple[dict, dict]:
    """Return (params', batch_stats') with conv+frozen-BN pairs folded.

    Only touches sibling conv/BN pairs matched by name; everything else
    (heads, the bottleneck conv) is unchanged. The inputs are not
    modified.
    """
    params = _copy(params)
    batch_stats = _copy(batch_stats)

    def visit(pnode, snode):
        if not isinstance(pnode, dict):
            return
        for conv_name in list(pnode.keys()):
            bn_name = _bn_name_for(conv_name)
            if (bn_name and bn_name in pnode
                    and isinstance(pnode[conv_name], dict)
                    and 'kernel' in pnode[conv_name]):
                conv = pnode[conv_name]
                bnp = pnode[bn_name]['bn']
                bns = snode[bn_name]['bn']
                gamma, beta = bnp['scale'], bnp['bias']
                mean, var = bns['mean'], bns['var']
                k = gamma / np.sqrt(var + BN_EPS)
                # Scale into the kernel (+ conv bias when present); the
                # shift stays in the BN bias.
                conv['kernel'] = conv['kernel'] * k
                if 'bias' in conv:
                    conv['bias'] = conv['bias'] * k
                bnp['scale'] = np.ones_like(gamma)
                bnp['bias'] = beta - mean * k
                bns['mean'] = np.zeros_like(mean)
                bns['var'] = np.ones_like(var) - BN_EPS
        for key, sub in pnode.items():
            if isinstance(sub, dict):
                visit(sub, snode.get(key, {}) if isinstance(snode, dict)
                      else {})

    visit(params, batch_stats)
    return params, batch_stats
