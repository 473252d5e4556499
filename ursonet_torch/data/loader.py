"""On-device preprocessing of a raw batch, the counterpart of
`ursonet_tpu/data/loader.py::make_device_preprocess`.

A raw batch is what the host loader hands over: uint8 images already
resized to the network shape, the raw pose and the image meta. On the
device the preprocess runs the rotation augmentation (homography warp in
the CUDA kernel, pose update), re-encodes the orientation PMF from the
rotated quaternion and subtracts the mean pixel. In keypoint mode
(REGRESS_KEYPOINTS) it passes the raw keypoint targets through, or
recomputes them from the rotated pose. The images stay f32 into the
warp under F16 too (the model casts them to bf16), as in the JAX
package. The file-based host loader is not part of this port yet;
callers build raw batches in memory.
"""

from __future__ import annotations

import numpy as np
import torch

from ursonet_torch import se3t
from ursonet_torch.data.urso import Camera
from ursonet_torch.device import resolve_device
from ursonet_torch.ops import augment as aug
from ursonet_torch.ops import encoders
from ursonet_torch.ops.image import resize_geometry


def as_tensor(x, dev: torch.device, dtype=None) -> torch.Tensor:
    """numpy array or tensor -> tensor on `dev` (optionally cast)."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(dev, dtype) if dtype is not None else x.to(dev)


def keypoint_scale(dataset_name: str) -> float:
    """Distance of the virtual keypoints from the centroid: 3 m for URSO
    frames, 1 otherwise (`ursonet_tpu/data/loader.py:402`)."""
    return 3.0 if dataset_name == 'Urso' else 1.0


class DevicePreprocess:
    """raw batch dict -> model batch dict {'images' [B,3,H,W] f32,
    'image_meta', 'gt_loc', 'gt_ori'} ({'gt_loc', 'gt_k1', 'gt_k2'} in
    keypoint mode).

    `draw(generator, b)` makes the random draws of one batch;
    `__call__(raw, draws)` is deterministic given them.
    """

    def __init__(self, config, camera, dev: torch.device,
                 dataset_name: str = 'Urso'):
        self.config = config
        self.device = dev
        self.kp_scale = keypoint_scale(dataset_name)
        self.rot = bool(config.ROT_AUG or config.ROT_IMAGE_AUG)
        self.interpolation = config.WARP_INTERPOLATION
        self.mean_pixel = torch.as_tensor(
            np.asarray(config.MEAN_PIXEL), dtype=torch.float32,
            device=dev).view(1, -1, 1, 1)
        # Static resize geometry of the camera's frames.
        _, window, scale = resize_geometry(
            camera.height, camera.width, min_dim=config.IMAGE_MIN_DIM,
            max_dim=config.IMAGE_MAX_DIM, min_scale=config.IMAGE_MIN_SCALE,
            mode=config.IMAGE_RESIZE_MODE)
        K_net = aug.scaled_intrinsics(camera.K, window, scale)
        self.K_net = torch.as_tensor(K_net, dtype=torch.float32, device=dev)
        self.ori_grid_quat = self.ori_grid_mask = None
        if not config.REGRESS_ORI:
            grid = encoders.build_ori_grid(config.ORI_BINS_PER_DIM)
            self.ori_grid_quat = torch.as_tensor(grid.quat, device=dev)
            self.ori_grid_mask = torch.as_tensor(grid.mask, device=dev)

    def draw(self, generator: torch.Generator, b: int):
        """Random draws for a batch of `b` (None when nothing is random)."""
        if not self.rot:
            return None
        if generator is None:
            raise ValueError("rotation augmentation needs a torch.Generator")
        return aug.draw_rotation(generator, b, 20.0)

    def __call__(self, raw, draws=None):
        cfg = self.config
        dev = self.device
        images = as_tensor(raw['images_u8'], dev)          # [B,H,W,C] u8
        images = images.permute(0, 3, 1, 2).contiguous().to(torch.float32)
        locs = as_tensor(raw['location'], dev, torch.float32)
        quats = as_tensor(raw['quaternion'], dev, torch.float32)

        if self.rot:
            if draws is None:
                raise ValueError("rotation augmentation needs draws "
                                 "(DevicePreprocess.draw)")
            images, locs, quats = aug.rotation_augment_apply(
                images, locs, quats, self.K_net, draws, cfg.ROT_AUG,
                cfg.ROT_IMAGE_AUG, self.interpolation)

        batch = {'images': images - self.mean_pixel,
                 'image_meta': as_tensor(raw['image_meta'], dev,
                                         torch.float32)}
        if cfg.REGRESS_KEYPOINTS:
            batch['gt_loc'] = locs
            if self.rot:
                # K1 = R·(s·e3) + loc, K2 = R·(s·e2) + loc
                R = se3t.quat2SO3(quats)
                batch['gt_k1'] = R[..., :, 2] * self.kp_scale + locs
                batch['gt_k2'] = R[..., :, 1] * self.kp_scale + locs
            else:
                batch['gt_k1'] = as_tensor(raw['gt_k1'], dev, torch.float32)
                batch['gt_k2'] = as_tensor(raw['gt_k2'], dev, torch.float32)
            return batch
        batch['gt_loc'] = locs if cfg.REGRESS_LOC else \
            as_tensor(raw['loc_map'], dev, torch.float32)
        if cfg.REGRESS_ORI:
            if cfg.ORIENTATION_PARAM == 'quaternion':
                batch['gt_ori'] = quats
            elif cfg.ORIENTATION_PARAM == 'euler_angles':
                batch['gt_ori'] = as_tensor(raw['pyr'], dev, torch.float32)
            else:
                batch['gt_ori'] = as_tensor(raw['angleaxis'], dev,
                                            torch.float32)
        else:
            # On-device PMF (re-)encode; the same formula whether or not
            # the sample was rotated.
            batch['gt_ori'] = encoders.encode_ori_pmf(
                quats, self.ori_grid_quat, self.ori_grid_mask, cfg.BETA,
                cfg.ORI_BINS_PER_DIM)
        return batch


def make_device_preprocess(config, camera=None, device="cuda",
                           dataset_name: str = 'Urso'):
    """Build the on-device preprocess for `config` and the camera whose
    frames the raw batches hold (URSO's by default). `dataset_name` sets
    the keypoint scale (`keypoint_scale`), as the JAX package's
    `dataset.name` does."""
    dev = resolve_device(device)
    if config.SIM2REAL_AUG:
        raise NotImplementedError(
            "SIM2REAL_AUG: the sim2real pipeline (and the grayscale warp "
            "path it feeds) is ported in a later slice")
    if (config.ROT_AUG or config.ROT_IMAGE_AUG) and not (
            config.REGRESS_LOC and config.ORIENTATION_PARAM == 'quaternion'):
        raise ValueError("rotation augmentation needs REGRESS_LOC and "
                         "quaternion orientations")
    return DevicePreprocess(config, camera or Camera(), dev, dataset_name)
