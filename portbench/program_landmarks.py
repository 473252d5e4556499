"""What the landmark cells take from the program under test
(`ursonet_torch`), beside `program.py`: the landmark model (BACKBONE
'hrnet_w32') with its landmark count, its train step over a resident
dataset for a camera the cell gives, and the program's HRNet counter.
Every import of the program for these cells is here."""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch


def build_model(cfg, device):
    """The program's landmark model for `cfg`, its tensors allocated on
    `device` and not initialised (the benchmark loads its own weights)."""
    from ursonet_torch.models.ursonet import UrsoNetModule
    h, w = int(cfg.IMAGE_SHAPE[0]), int(cfg.IMAGE_SHAPE[1])
    with torch.device('meta'):
        model = UrsoNetModule(
            (h, w), backbone=cfg.BACKBONE, train_bn=cfg.TRAIN_BN,
            dtype=torch.bfloat16 if cfg.F16 else torch.float32,
            remat=cfg.REMAT, landmarks=int(cfg.NUM_LANDMARKS))
    return model.to_empty(device=device)


def resident_train_step(cfg, device, model, n_images: int, k_cam,
                        frame_hw):
    """The program's train step over a device-resident dataset of
    `n_images` frames of `frame_hw` pixels taken by a camera of
    intrinsics `k_cam` [3,3], with its optimizer and on-device
    preprocess: (step fn(data, perm, i, generator) -> (i + 1, metrics),
    optimizer)."""
    from ursonet_torch.data.loader import make_device_preprocess
    from ursonet_torch.train.optim import make_optimizer
    from ursonet_torch.train.step import make_resident_train_step
    camera = SimpleNamespace(K=np.asarray(k_cam, np.float64),
                             height=int(frame_hw[0]), width=int(frame_hw[1]))
    tx = make_optimizer(cfg)
    pre = make_device_preprocess(cfg, camera, device, 'speed')
    step = make_resident_train_step(model, cfg, tx, n_images, None, pre,
                                    device)
    return step, tx


def counts() -> dict:
    """The program's landmark counter (`ops/landmarks.py::counts`), its
    device tensors read."""
    from ursonet_torch.ops import landmarks
    return {k: int(v) for k, v in landmarks.counts.items()}


def reset_counts() -> None:
    from ursonet_torch.ops import landmarks
    landmarks.reset_counts()
