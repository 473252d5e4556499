"""Input pipeline, the counterpart of `ursonet_tpu/data/loader.py` in
its on-device mode (AUGMENT_ON_DEVICE).

The host side reads frames from disk, decodes them (`data/png.py`),
resizes them to the network shape and batches them as uint8 with the
raw pose and the image meta: `data_generator` (raw mode), run in a
background thread by `Prefetcher`. A dataset small enough
(`use_resident`) is instead loaded once onto the device
(`load_dataset_resident`) and batched there by an index gather
(`train/step.py::make_resident_train_step`).

On the device the preprocess runs the rotation augmentation (homography
warp in the CUDA kernel, pose update), re-encodes the orientation PMF
from the rotated quaternion and subtracts the mean pixel. In keypoint
mode (REGRESS_KEYPOINTS) it passes the raw keypoint targets through, or
recomputes them from the rotated pose. The images stay f32 into the
warp under F16 too (the model casts them to bf16), as in the JAX
package.

Not ported yet: the host-parity generator (`raw=False`: per-image
augmentation on the host with cv2's warpPerspective and GaussianBlur),
the native C++ batch loader, and multi-host batch slices.
"""

from __future__ import annotations

import logging
import queue
import threading
import warnings
from typing import Iterator, Optional

import numpy as np
import torch

from ursonet_torch import se3t
from ursonet_torch.data.urso import Camera
from ursonet_torch.device import resolve_device
from ursonet_torch.ops import augment as aug
from ursonet_torch.ops import encoders
from ursonet_torch.ops import image as imops
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


# --------------------------------------------------------------------------
# host loader


def _raw_pose_fields(dataset, config, image_id) -> dict:
    """Pose and ground-truth fields of a raw sample (all but the image)."""
    sample = {
        'location': np.asarray(dataset.load_location(image_id), np.float32),
        'quaternion': np.asarray(dataset.load_quaternion(image_id),
                                 np.float32),
    }
    if not config.REGRESS_LOC:
        sample['loc_map'] = np.asarray(
            dataset.load_location_encoded(image_id), np.float32)
    if config.REGRESS_ORI and config.ORIENTATION_PARAM == 'euler_angles':
        sample['pyr'] = np.asarray(dataset.load_euler_angles(image_id),
                                   np.float32)
    if config.REGRESS_ORI and config.ORIENTATION_PARAM == 'angle_axis':
        sample['angleaxis'] = np.asarray(dataset.load_angle_axis(image_id),
                                         np.float32)
    if config.REGRESS_KEYPOINTS:
        kps = dataset.load_keypoints(image_id)
        sample['gt_k1'] = np.asarray(kps[0], np.float32).reshape(3)
        sample['gt_k2'] = np.asarray(kps[1], np.float32).reshape(3)
    return sample


def _load_raw(dataset, config, image_id) -> dict:
    """One raw sample: the frame decoded and resized to the network
    shape (uint8), its meta and its pose fields."""
    image = dataset.load_image(image_id)
    original_shape = image.shape
    image, window, scale, _, _ = imops.resize_image(
        image, min_dim=config.IMAGE_MIN_DIM, min_scale=config.IMAGE_MIN_SCALE,
        max_dim=config.IMAGE_MAX_DIM, mode=config.IMAGE_RESIZE_MODE)
    meta = imops.compose_image_meta(image_id, original_shape, image.shape,
                                    window, scale)
    sample = {'images_u8': image.astype(np.uint8), 'image_meta': meta}
    sample.update(_raw_pose_fields(dataset, config, image_id))
    return sample


def data_generator(dataset, config, shuffle=True, batch_size=1,
                   seed: Optional[int] = None, raw: Optional[bool] = None,
                   batch_slice=None) -> Iterator[dict]:
    """Infinite generator of raw batches (numpy): {'images_u8' [B,H,W,3],
    'image_meta', 'location', 'quaternion', ...}.

    The ids are shuffled by `np.random.RandomState(seed)` at the start
    of every pass, as the JAX package's generator shuffles them, so both
    yield the same batches. A frame that fails to load is logged and
    skipped; the sixth failure raises. raw=None follows
    AUGMENT_ON_DEVICE; raw=False (the host-parity generator) and
    `batch_slice` (multi-host input sharding) are not ported and raise
    here, when the generator is made.
    """
    if raw is None:
        raw = bool(getattr(config, 'AUGMENT_ON_DEVICE', True))
    if not raw:
        raise NotImplementedError(
            'raw=False: the host-parity generator (per-image augmentation '
            'with ports of cv2 warpPerspective and GaussianBlur) is a later '
            'slice (ROADMAP §1); use AUGMENT_ON_DEVICE')
    if batch_slice is not None:
        raise NotImplementedError(
            'batch_slice: multi-host input sharding comes with the '
            'parallel slice (ROADMAP §1)')
    if getattr(config, 'NATIVE_LOADER', True):
        _say_python_path()
    return _raw_batches(dataset, config, shuffle, batch_size, seed)


def _say_python_path():
    # one warning location: Python's default filter shows it once
    warnings.warn('NATIVE_LOADER: the native C++ batch loader is not '
                  'ported; the loader decodes and resizes in Python')


def _raw_batches(dataset, config, shuffle, batch_size, seed):
    rng = np.random.RandomState(seed)
    image_ids = np.copy(dataset.image_ids)
    b = 0
    image_index = -1
    error_count = 0
    batch = {}
    while True:
        try:
            image_index = (image_index + 1) % len(image_ids)
            if shuffle and image_index == 0:
                rng.shuffle(image_ids)
            image_id = int(image_ids[image_index])
            sample = _load_raw(dataset, config, image_id)
            if not batch:
                batch = {k: np.zeros((batch_size,) + np.shape(v),
                                     dtype=np.asarray(v).dtype)
                         for k, v in sample.items()}
            for k, v in sample.items():
                batch[k][b] = v
            b += 1
            if b >= batch_size:
                yield batch
                b = 0
                batch = {}
        except (GeneratorExit, KeyboardInterrupt):
            raise
        except Exception:
            logging.exception("Error processing image %s",
                              dataset.image_info[image_id])
            error_count += 1
            if error_count > 5:
                raise


_DONE = object()  # Prefetcher end-of-stream sentinel


class Prefetcher:
    """Runs a generator in a background thread, `depth` items ahead. Works
    for infinite generators (training) and finite ones; an error in the
    producer is raised in the consumer, and again on every later call.
    `close()` stops the thread and closes the generator."""

    def __init__(self, it: Iterator, depth: int = 8):
        self._it = it
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._err = None
        self._exhausted = False
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        """Queue `item` unless close() comes first; False if it did."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.05)
                return True
            except queue.Full:
                pass
        return False

    def _run(self):
        try:
            for item in self._it:
                if not self._put(item):
                    return
        except Exception as e:  # propagate to the consumer
            self._err = e
        self._put(_DONE)

    def close(self, timeout: float = 60.0) -> None:
        """Stop the producer (after the item it is making) and close the
        generator; the queued items are dropped."""
        self._stop.set()
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise RuntimeError('the prefetch thread did not stop')
        if hasattr(self._it, 'close'):
            self._it.close()

    def __iter__(self):
        return self

    def __next__(self):
        if self._exhausted:
            if self._err is not None:
                raise self._err
            raise StopIteration
        item = self._q.get()
        if item is _DONE:
            self._exhausted = True
            raise self._err if self._err else StopIteration
        return item


# --------------------------------------------------------------------------
# device-resident datasets


def resident_bytes(dataset, config) -> int:
    """Device bytes of the resident raw arrays of `dataset` (one sample
    loaded and measured, times the number of images)."""
    probe = _load_raw(dataset, config, int(dataset.image_ids[0]))
    return sum(np.asarray(v).nbytes for v in probe.values()) \
        * len(dataset.image_ids)


def use_resident(dataset, config) -> bool:
    """Whether to keep `dataset` resident on the device for training:
    DATA_ON_DEVICE True forces it, False refuses, 'auto' compares
    resident_bytes with DATA_ON_DEVICE_MAX_MB. Only with the on-device
    augmentation (AUGMENT_ON_DEVICE)."""
    knob = getattr(config, 'DATA_ON_DEVICE', 'auto')
    if knob is False or not getattr(config, 'AUGMENT_ON_DEVICE', True):
        return False
    if knob is True:
        return True
    cap = int(getattr(config, 'DATA_ON_DEVICE_MAX_MB', 1024)) * (1 << 20)
    return resident_bytes(dataset, config) <= cap


def load_dataset_resident(dataset, config, device="cuda"):
    """Load every frame of `dataset` as a raw sample and upload the stack
    once: returns ({field: tensor [N, ...] on `device`}, N)."""
    dev = resolve_device(device)
    ids = [int(i) for i in dataset.image_ids]
    samples = [_load_raw(dataset, config, i) for i in ids]
    data = {k: torch.from_numpy(np.stack([s[k] for s in samples])).to(dev)
            for k in samples[0]}
    return data, len(ids)
