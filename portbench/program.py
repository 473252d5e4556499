"""What the benchmark takes from the program under test (`ursonet_torch`):
its configuration object, its model, its serving engine and its train
step, and nothing of its yardsticks. Every import of the program is
here."""

from __future__ import annotations

import torch


def build_kernels() -> None:
    """Build the program's CUDA sources that its checkout has not built
    yet (all at once; a checkout's later runs find them built)."""
    from ursonet_torch.ops import cuda_build
    cuda_build.build_all()


def make_config(keys: dict):
    """The program's Config with `keys` set, then derived (`update`)."""
    from ursonet_torch.config import Config
    cfg = Config()
    for k, v in keys.items():
        setattr(cfg, k, v)
    cfg.update()
    return cfg


def build_model(cfg, device):
    """The program's model for `cfg`, its tensors allocated on `device`
    and not initialised (the benchmark loads its own weights)."""
    from ursonet_torch.models.ursonet import UrsoNetModule
    h, w = int(cfg.IMAGE_SHAPE[0]), int(cfg.IMAGE_SHAPE[1])
    with torch.device('meta'):
        model = UrsoNetModule(
            (h, w), backbone=cfg.BACKBONE,
            bottleneck_width=cfg.BOTTLENECK_WIDTH,
            branch_size=cfg.BRANCH_SIZE,
            nr_dense_layers=cfg.NR_DENSE_LAYERS,
            regress_loc=cfg.REGRESS_LOC, regress_ori=cfg.REGRESS_ORI,
            orientation_param=cfg.ORIENTATION_PARAM,
            loc_bins=cfg.LOC_BINS_PER_DIM, ori_bins=cfg.ORI_BINS_PER_DIM,
            train_bn=cfg.TRAIN_BN,
            dtype=torch.bfloat16 if cfg.F16 else torch.float32,
            regress_keypoints=cfg.REGRESS_KEYPOINTS, remat=cfg.REMAT)
    return model.to_empty(device=device)


def float_shapes(model) -> dict:
    """{name: shape} of the model's float tensors (parameters and batch
    norm statistics), in state-dict order."""
    return {k: tuple(v.shape) for k, v in model.state_dict().items()
            if v.is_floating_point()}


def serving_engine(cfg, device, model):
    from ursonet_torch.engine import ServingEngine
    return ServingEngine(cfg, device, model=model)


def resident_train_step(cfg, device, model, n_images: int):
    """The program's train step over a device-resident dataset of
    `n_images` frames, with its optimizer and on-device preprocess for
    URSO's camera: (step fn(data, perm, i, generator) -> (i + 1,
    metrics), optimizer)."""
    from ursonet_torch.data.loader import make_device_preprocess
    from ursonet_torch.data.urso import Camera
    from ursonet_torch.train.optim import make_optimizer
    from ursonet_torch.train.step import make_resident_train_step
    tx = make_optimizer(cfg)
    pre = make_device_preprocess(cfg, Camera(), device, 'Urso')
    step = make_resident_train_step(model, cfg, tx, n_images, None, pre,
                                    device)
    return step, tx
