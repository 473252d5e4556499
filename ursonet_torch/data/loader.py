"""Input pipeline, the counterpart of `ursonet_tpu/data/loader.py` in
its on-device mode (AUGMENT_ON_DEVICE).

The host side reads frames from disk, decodes them, resizes them to the
network shape and batches them as uint8 with the raw pose and the image
meta: `data_generator` (raw mode), run in a background thread by
`Prefetcher`. Under NATIVE_LOADER (the default) with a fixed geometry
(IMAGE_RESIZE_MODE none, square or pad64) one call of the native loader
(`data/native_loader.py`, threaded C++) decodes, resizes and places a
whole batch, as the JAX package's native route does; otherwise each
frame is decoded by `data/png.py` or `data/jpeg.py` and resized by
`ops/image.resize_image` in Python. A dataset small enough
(`use_resident`) is instead loaded once onto the device
(`load_dataset_resident`) and batched there by an index gather
(`train/step.py::make_resident_train_step`).

On the device the preprocess runs sim2real (gray, then noise, blur,
brightness, contrast and coarse dropout in a random order), the rotation
augmentation (pose update; the homography warp, the select of the
images left unrotated and the mean-pixel subtraction as one launch of
the CUDA kernel `warp_cuda.warp_mold`, from the raw u8 batch or, after
sim2real, from the one gray plane) and re-encodes the orientation PMF
from the rotated quaternion. Without rotation the cast and the mold
are plain PyTorch. In keypoint
mode (REGRESS_KEYPOINTS) it passes the raw keypoint targets through, or
recomputes them from the rotated pose. For the landmark model (BACKBONE
'hrnet_w32') it projects the configuration's landmarks with the network
intrinsics and the (rotated) pose (URSO's labels permuted from the
Unreal frame) and renders HRNet's Gaussian heatmap
targets and visibility weights (`ops/landmarks.py`, span
ursonet.train.targets), counting the landmarks rendered and dropped as
out of view in `ops/landmarks.py::counts`. The images stay f32 into the
warp under F16 too (the model casts them to bf16), as in the JAX
package.

The host-parity generator (`raw=False`, AUGMENT_ON_DEVICE False) is the
reference's data path instead: per frame at its own resolution,
sim2real, then the camera rotation or roll (`load_image_gt`: numpy draws
from one `RandomState`, the port's numpy versions of cv2's
warpPerspective and GaussianBlur), the resize and the mold on the host;
it yields molded [B,H,W,3] batches (float16 under F16), which
`molded_to_device` hands to a step made without a preprocess.

Over several ranks each loads only its rows of every global batch
(`data_generator(batch_slice=...)`): the id stream is the whole
deterministic global one on every rank, so the batches' composition
agrees with no communication.
"""

from __future__ import annotations

import logging
import queue
import threading
from typing import Iterator, Optional

import numpy as np
import torch

from ursonet_torch import se3t
from ursonet_torch.data.urso import Camera, encode_as_keypoints
from ursonet_torch.device import resolve_device
from ursonet_torch.ops import augment as aug
from ursonet_torch.ops import encoders
from ursonet_torch.ops import image as imops
from ursonet_torch.ops import landmarks as lm
from ursonet_torch.ops import warp_cuda
from ursonet_torch.ops.image import resize_geometry
from ursonet_torch.parallel.multihost import slice_rows
from ursonet_torch.utils.profiling import span


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
    keypoint mode; {'gt_heatmaps' [B,K,H/4,W/4], 'gt_weights' [B,K],
    'gt_landmarks' [B,K,2] network pixels} for the landmark model).

    `draw(generator, b)` makes the random draws of one batch: the
    rotation's (`augment.draw_rotation`) with, under SIM2REAL_AUG, the
    sim2real draws under 'sim2real' (drawn first, as the JAX package
    splits its key for sim2real first); `__call__(raw, draws)` is
    deterministic given them.
    """

    def __init__(self, config, camera, dev: torch.device,
                 dataset_name: str = 'Urso'):
        self.config = config
        self.device = dev
        self.kp_scale = keypoint_scale(dataset_name)
        self.rot = bool(config.ROT_AUG or config.ROT_IMAGE_AUG)
        self.sim2real = bool(config.SIM2REAL_AUG)
        self.interpolation = config.WARP_INTERPOLATION
        self.mean = np.asarray(config.MEAN_PIXEL, np.float32)
        self.mean_pixel = torch.as_tensor(self.mean,
                                          device=dev).view(1, -1, 1, 1)
        # Static resize geometry of the camera's frames.
        self.shape, window, scale = resize_geometry(
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
        self.landmarks = None
        # URSO's labels are in the Unreal frame (`ops/landmarks.py`)
        self.label_frame = 'unreal' if dataset_name == 'Urso' else 'camera'
        if lm.is_heatmap_model(config.BACKBONE):
            self.landmarks = torch.as_tensor(lm.landmarks_of(config),
                                             device=dev)

    def draw(self, generator: torch.Generator, b: int):
        """Random draws for a batch of `b` (None when nothing is random).
        Sim2real's noise field has the network shape of the camera's
        frames, the shape the raw batches hold."""
        if not (self.rot or self.sim2real):
            return None
        if generator is None:
            raise ValueError("augmentation needs a torch.Generator")
        draws = {}
        if self.sim2real:
            draws['sim2real'] = aug.draw_sim2real(
                generator, b, *self.shape,
                bool(getattr(self.config, 'SIM2REAL_PER_IMAGE_ORDER', False)))
        if self.rot:
            draws.update(aug.draw_rotation(generator, b, 20.0))
        return draws

    def __call__(self, raw, draws=None):
        cfg = self.config
        dev = self.device
        if (self.rot or self.sim2real) and draws is None:
            raise ValueError("augmentation needs draws "
                             "(DevicePreprocess.draw)")
        src = as_tensor(raw['images_u8'], dev).contiguous()  # [B,H,W,C] u8
        locs = as_tensor(raw['location'], dev, torch.float32)
        quats = as_tensor(raw['quaternion'], dev, torch.float32)

        if self.sim2real:
            images = src.permute(0, 3, 1, 2).contiguous().to(torch.float32)
            # the gray plane [B,1,H,W] of the broadcast result
            src = aug.sim2real_apply(images, draws['sim2real'])[:, :1]
        if self.rot:
            # warp, identity select and mold in one launch on the card
            M, identity, locs, quats = aug.rotation_update(
                locs, quats, self.K_net, draws, cfg.ROT_AUG,
                cfg.ROT_IMAGE_AUG)
            images = warp_cuda.warp_mold(src, M, identity, self.mean,
                                         self.interpolation)
        else:
            if not self.sim2real:
                src = src.permute(0, 3, 1, 2).contiguous().to(torch.float32)
            images = src - self.mean_pixel

        batch = {'images': images,
                 'image_meta': as_tensor(raw['image_meta'], dev,
                                         torch.float32)}
        if self.landmarks is not None:
            batch.update(self.targets(locs, quats))
            return batch
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

    def targets(self, locs, quats) -> dict:
        """The landmark model's targets for the batch's poses."""
        with span('ursonet.train.targets'):
            pixels, depths = lm.project(self.landmarks, locs, quats,
                                        self.K_net, self.label_frame)
            hm, wm = (n // lm.HEATMAP_STRIDE for n in self.shape)
            heat, weights = lm.render(pixels, depths, (hm, wm),
                                      lm.HEATMAP_STRIDE,
                                      float(self.config.HEATMAP_SIGMA))
            lm.count(rendered=weights.numel(),
                        dropped=weights.numel() - weights.sum().long())
        return {'gt_heatmaps': heat, 'gt_weights': weights,
                'gt_landmarks': pixels}


def make_device_preprocess(config, camera=None, device="cuda",
                           dataset_name: str = 'Urso'):
    """Build the on-device preprocess for `config` and the camera whose
    frames the raw batches hold (URSO's by default; SPEED's for SPEED
    frames: the rotation's intrinsics come from it). `dataset_name` sets
    the keypoint scale (`keypoint_scale`), as the JAX package's
    `dataset.name` does."""
    dev = resolve_device(device)
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


def load_image_gt(dataset, config, image_id, rng):
    """One host-parity sample, the reference's per-frame load and
    augmentation (the JAX package's `load_image_gt`): the frame, then
    under SIM2REAL_AUG `augment.sim2real_host`, then under ROT_AUG /
    ROT_IMAGE_AUG one dice (`rng.rand(1)`) picks the camera rotation
    (above 0.5) or the roll, warped at the frame's resolution with the
    pose (and the keypoints, at scale 1, or the orientation PMF) updated;
    then the resize to the network shape. Returns (image, image_meta,
    loc, ori) or (image, image_meta, loc, k1, k2) in keypoint mode."""
    image = dataset.load_image(image_id)

    if config.REGRESS_LOC:
        loc = np.asarray(dataset.load_location(image_id), np.float64)
    else:
        loc = dataset.load_location_encoded(image_id)

    k1 = k2 = None
    if config.REGRESS_KEYPOINTS:
        keypoints = dataset.load_keypoints(image_id)
        k1, k2 = keypoints[0], keypoints[1]

    if config.REGRESS_KEYPOINTS or config.REGRESS_ORI:
        if config.ORIENTATION_PARAM == 'quaternion':
            ori = np.asarray(dataset.load_quaternion(image_id), np.float64)
        elif config.ORIENTATION_PARAM == 'euler_angles':
            ori = np.asarray(dataset.load_euler_angles(image_id), np.float64)
        elif config.ORIENTATION_PARAM == 'angle_axis':
            ori = np.asarray(dataset.load_angle_axis(image_id), np.float64)
    else:
        ori = dataset.load_orientation_encoded(image_id)

    if config.SIM2REAL_AUG:
        image = aug.sim2real_host(image, rng)

    if config.ROT_AUG or config.ROT_IMAGE_AUG:
        if not (config.REGRESS_LOC
                and config.ORIENTATION_PARAM == 'quaternion'):
            raise ValueError("rotation augmentation needs REGRESS_LOC and "
                             "quaternion orientations")
        dice = rng.rand(1)[0]
        pose_ori = config.REGRESS_KEYPOINTS or config.REGRESS_ORI
        q = ori if pose_ori else dataset.load_quaternion(image_id)
        K = dataset.camera.K
        if config.ROT_AUG and dice > 0.5:
            image, loc, q = aug.rotate_cam(image, loc, q, K, 20, rng)
        elif config.ROT_IMAGE_AUG and dice <= 0.5:
            image, loc, q = aug.rotate_image(image, loc, q, K, rng)
        else:
            q = None
        if q is not None and pose_ori:
            ori = q
            k1, k2 = encode_as_keypoints(ori, loc)
            k1, k2 = k1[0], k2[0]
        elif q is not None:
            ori = encoders.encode_ori_fast(q, config.BETA,
                                           dataset.ori_histogram_map,
                                           dataset.ori_output_mask)

    original_shape = image.shape
    image, window, scale, _, _ = imops.resize_image(
        image, min_dim=config.IMAGE_MIN_DIM, min_scale=config.IMAGE_MIN_SCALE,
        max_dim=config.IMAGE_MAX_DIM, mode=config.IMAGE_RESIZE_MODE)
    image_meta = imops.compose_image_meta(image_id, original_shape,
                                          image.shape, window, scale)
    if config.REGRESS_KEYPOINTS:
        return image, image_meta, loc, np.asarray(k1).reshape(3), \
            np.asarray(k2).reshape(3)
    return image, image_meta, loc, ori


def _load_parity(dataset, config, image_id, rng, dtype) -> dict:
    """One host-parity sample as batch fields: the molded image and the
    targets in `dtype` (float16 under F16), the meta as it is."""
    out = load_image_gt(dataset, config, image_id, rng)
    image, meta, loc = out[:3]
    sample = {'images': imops.mold_image(image.astype(dtype), config),
              'image_meta': meta, 'gt_loc': np.asarray(loc, dtype)}
    if config.REGRESS_KEYPOINTS:
        sample['gt_k1'] = np.asarray(out[3], dtype)
        sample['gt_k2'] = np.asarray(out[4], dtype)
    else:
        sample['gt_ori'] = np.asarray(out[3], dtype)
    return sample


def data_generator(dataset, config, shuffle=True, batch_size=1,
                   seed: Optional[int] = None, raw: Optional[bool] = None,
                   batch_slice=None) -> Iterator[dict]:
    """Infinite batch generator (numpy). raw=None follows
    AUGMENT_ON_DEVICE. raw=True yields raw batches: {'images_u8'
    [B,H,W,3], 'image_meta', 'location', 'quaternion', ...}; raw=False
    (the host-parity generator) yields augmented, molded batches:
    {'images' [B,H,W,3], 'image_meta', 'gt_loc', 'gt_ori'} (or 'gt_k1',
    'gt_k2' for 'gt_ori' in keypoint mode), float16 under F16.

    The ids are shuffled by `np.random.RandomState(seed)` at the start
    of every pass, as the JAX package's generator shuffles them, so both
    yield the same ids. The host-parity augmentation draws from a second
    stream, `np.random.RandomState(seed + 104729 + first row)` (the JAX
    package's stream of the first row it loads), sample after sample: a
    new generator restarts it. Under NATIVE_LOADER with a fixed geometry
    (`native_geometry`) each raw batch is one call of the native loader;
    a batch that fails is logged and skipped. Otherwise (and always for
    raw=False, as in the JAX package) a frame that fails to load is
    logged and skipped. Either way the sixth failure raises.

    batch_slice: a rank's rows of each global batch of `batch_size`,
    (lo, hi) or an index array (`parallel/multihost.py::
    local_batch_slice`): the id stream is the whole global one, and only
    those rows are loaded and yielded. Then any per-image error raises at
    once: a skip would desynchronize the global stream across ranks.
    """
    if raw is None:
        raw = bool(getattr(config, 'AUGMENT_ON_DEVICE', True))
    rows = slice_rows(batch_slice, batch_size)
    strict = batch_slice is not None
    if not raw:
        aug_rng = np.random.RandomState(
            None if seed is None else seed + 104729 + int(rows[0]))
        dtype = np.float16 if config.F16 else np.float32
        return _batches(dataset, shuffle, batch_size, seed,
                        lambda i: _load_parity(dataset, config, i, aug_rng,
                                               dtype), rows, strict)
    geom = native_geometry(dataset, config)
    if geom is not None:
        return _native_batches(dataset, config, shuffle, batch_size, seed,
                               geom, rows, strict)
    return _batches(dataset, shuffle, batch_size, seed,
                    lambda i: _load_raw(dataset, config, i), rows, strict)


def molded_to_device(batch, dev: torch.device) -> dict:
    """The model batch of a host-parity batch: every field on `dev` in
    f32 but the molded images, which go [B,H,W,3] -> [B,3,H,W] in their
    own dtype (float16 under F16: the model casts them to its compute
    dtype, as the JAX model casts the float16 batch to bfloat16)."""
    out = {k: as_tensor(v, dev, torch.float32)
           for k, v in batch.items() if k != 'images'}
    out['images'] = as_tensor(batch['images'], dev).permute(
        0, 3, 1, 2).contiguous()
    return out


def native_geometry(dataset, config) -> Optional[dict]:
    """Where the native loader puts a frame of `dataset`'s camera, from
    one probe frame through `resize_image` (as the JAX package's native
    route probes it): out_h, out_w, content_h, content_w, top, left and
    the meta's window and scale. None when NATIVE_LOADER is off or the
    resize mode is not a fixed geometry (crop draws its offset)."""
    if not (getattr(config, 'NATIVE_LOADER', True)
            and config.IMAGE_RESIZE_MODE in ('none', 'square', 'pad64')):
        return None
    probe = np.zeros((dataset.camera.height, dataset.camera.width, 3),
                     np.uint8)
    resized, window, scale, _, _ = imops.resize_image(
        probe, min_dim=config.IMAGE_MIN_DIM, min_scale=config.IMAGE_MIN_SCALE,
        max_dim=config.IMAGE_MAX_DIM, mode=config.IMAGE_RESIZE_MODE)
    return {'out_h': resized.shape[0], 'out_w': resized.shape[1],
            'content_h': int(window[2] - window[0]),
            'content_w': int(window[3] - window[1]),
            'top': int(window[0]), 'left': int(window[1]),
            'meta_window': window, 'scale': scale}


def _id_stream(dataset, shuffle, seed):
    """The ids in the order both routes draw them, as the JAX package's
    generator does: pass after pass, reshuffled by
    `np.random.RandomState(seed)` at the start of each pass."""
    rng = np.random.RandomState(seed)
    image_ids = np.copy(dataset.image_ids)
    image_index = -1
    while True:
        image_index = (image_index + 1) % len(image_ids)
        if shuffle and image_index == 0:
            rng.shuffle(image_ids)
        yield int(image_ids[image_index])


def _native_batches(dataset, config, shuffle, batch_size, seed, g, rows,
                    strict):
    """Batches of the native loader: rows `rows` of each global batch;
    `strict`: raise at the first error."""
    from ursonet_torch.data import native_loader
    stream = _id_stream(dataset, shuffle, seed)
    error_count = 0
    orig_shape = (dataset.camera.height, dataset.camera.width, 3)
    while True:
        try:
            ids = [next(stream) for _ in range(batch_size)]
            ids = [ids[j] for j in rows]
            paths = [dataset.image_info[i]['path'] for i in ids]
            batch = {'images_u8': native_loader.load_batch(
                paths, g['out_h'], g['out_w'], g['content_h'],
                g['content_w'], g['top'], g['left'])}
            samples = [_raw_pose_fields(dataset, config, i) for i in ids]
            for k in samples[0]:
                batch[k] = np.stack([s[k] for s in samples])
            batch['image_meta'] = np.stack([
                imops.compose_image_meta(i, orig_shape,
                                         (g['out_h'], g['out_w'], 3),
                                         g['meta_window'], g['scale'])
                for i in ids])
            yield batch
        except (GeneratorExit, KeyboardInterrupt):
            raise
        except Exception:
            logging.exception("Error in native batch load")
            error_count += 1
            if strict or error_count > 5:
                raise


def _batches(dataset, shuffle, batch_size, seed, load, rows, strict):
    """Batches of the samples `load(image_id)` makes, frame by frame:
    rows `rows` of each global batch (the others are not loaded);
    `strict`: raise at the first error."""
    stream = _id_stream(dataset, shuffle, seed)
    row_pos = np.full(batch_size, -1, np.int64)
    row_pos[rows] = np.arange(len(rows))
    b = 0
    error_count = 0
    batch = {}
    while True:
        image_id = next(stream)
        try:
            pos = row_pos[b]
            if pos >= 0:
                sample = load(image_id)
                if not batch:
                    batch = {k: np.zeros((len(rows),) + np.shape(v),
                                         dtype=np.asarray(v).dtype)
                             for k, v in sample.items()}
                for k, v in sample.items():
                    batch[k][pos] = v
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
            if strict or error_count > 5:
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
