"""Shared helpers of the tests/test_torch_*.py files, which hold the
PyTorch port (ursonet_torch) against the JAX package (ursonet_tpu) on the
same inputs, made with numpy from a seed."""

import numpy as np
import pytest
import torch


@pytest.fixture
def cuda_device():
    """The card, for tests marked `cuda`; they skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA)")
    return torch.device("cuda")


def small_configs(mode='square', dim=64, **overrides):
    """The same small flagship-like configuration for both packages:
    ResNet-50, narrow heads, location regression, 6³-bin orientation
    classification, batch 2."""
    from ursonet_tpu.config import Config as JaxConfig
    from ursonet_torch.config import Config as TorchConfig
    out = []
    for cls in (JaxConfig, TorchConfig):
        cfg = cls()
        cfg.BACKBONE = 'resnet50'
        cfg.IMAGE_RESIZE_MODE = mode
        cfg.IMAGE_MIN_DIM = cfg.IMAGE_MAX_DIM = dim
        cfg.BRANCH_SIZE = 32
        cfg.BOTTLENECK_WIDTH = 16
        cfg.REGRESS_LOC = True
        cfg.REGRESS_ORI = False
        cfg.ORI_BINS_PER_DIM = 6
        cfg.IMAGES_PER_GPU = 2
        for k, v in overrides.items():
            setattr(cfg, k, v)
        cfg.update()
        out.append(cfg)
    return tuple(out)


def unit_quats(rng, n):
    q = rng.randn(n, 4)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return (q * np.where(q[:, 3:] < 0, -1.0, 1.0)).astype(np.float32)


def rel_l2(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)
