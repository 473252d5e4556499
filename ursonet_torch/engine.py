"""Serving engine: the serving half of `ursonet_tpu/engine.py::UrsoNet`.

    engine = ServingEngine(config)              # float model, seeded weights
    engine.quantize(calib_images)               # or load_serving_artifact()
    outputs = engine.predict_molded(molded)     # int8 after quantize()
    results = engine.detect(images)             # per-image head outputs

`predict_molded` is the one forward entry point: after `quantize()` or
`load_serving_artifact()` it serves the int8 model, and under
INT8_U8_INPUT it ships the batch as uint8 pixels, rint(molded + mean)
clipped to 0..255; otherwise it runs the float model in eval mode.
`detect` takes images already at the network resolution (pad64 may still
pad them); an image that needs resampling raises NotImplementedError.
Runs on `device` (default the card); the CPU only when asked for.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ursonet_torch.checkpoint.convert import params_to_jax_layout
from ursonet_torch.checkpoint.quant_store import load_quantized
from ursonet_torch.device import resolve_device
from ursonet_torch.models.quant import QuantizedModel
from ursonet_torch.models.ursonet import build_model
from ursonet_torch.ops.image import resize_geometry


def mold_image(image, config) -> np.ndarray:
    """Mean-subtract and cast to f32 (F16 is not ported)."""
    mean = np.asarray(config.MEAN_PIXEL)
    if image.shape[-1] == 3:
        return image.astype(np.float32) - mean.astype(np.float32)
    return image.astype(np.float32) - np.mean(mean).astype(np.float32)


def compose_image_meta(image_id, original_image_shape, image_shape, window,
                       scale) -> np.ndarray:
    """id(1) + original shape(3) + shape(3) + window(4) + scale(1)."""
    return np.array(
        [image_id] + list(original_image_shape) + list(image_shape) +
        list(window) + [scale], dtype=np.float32)


class ServingEngine:
    """Float and int8 serving of one configuration on one device."""

    def __init__(self, config, device='cuda', model=None,
                 generator: Optional[torch.Generator] = None):
        """`model`: the float model to serve, else one built for
        `config` with weights from `generator` when first needed (an
        engine that serves an artifact never builds it)."""
        self.config = config
        self.device = resolve_device(device)
        self._model = model
        self._generator = generator
        self.qmodel: Optional[QuantizedModel] = None

    @property
    def model(self):
        if self._model is None:
            self._model = build_model(self.config, self.device,
                                      self._generator)
        return self._model.eval()

    # -- int8 -----------------------------------------------------------------

    def quantize(self, calib_images: Optional[Sequence[np.ndarray]] = None,
                 headroom: float = 1.0) -> QuantizedModel:
        """Switch predict_molded() to the int8 model of the current float
        weights. calib_images: raw images for the activation calibration;
        without them it happens on the first served batch."""
        tree = params_to_jax_layout(self.model.state_dict())
        self.qmodel = QuantizedModel.from_variables(
            self.config, tree['params'], tree['batch_stats'], self.device)
        if calib_images is not None:
            molded, _, _ = self.mold_inputs(calib_images)
            self.qmodel.calibrate(molded, percentile_headroom=headroom)
        return self.qmodel

    def load_serving_artifact(self, path: str) -> QuantizedModel:
        """Serve a calibrated int8 artifact (checkpoint/quant_store.py)."""
        self.qmodel = load_quantized(path, self.config, self.device)
        return self.qmodel

    # -- forward --------------------------------------------------------------

    def predict_molded(self, molded) -> dict:
        """Forward a molded [B,H,W,3] batch (or, for the int8 model, raw
        uint8 pixels) through the serving path; returns head outputs as
        tensors on the device."""
        if self.qmodel is not None:
            if (getattr(self.config, 'INT8_U8_INPUT', True)
                    and not (isinstance(molded, np.ndarray)
                             and molded.dtype == np.uint8)
                    and not (isinstance(molded, torch.Tensor)
                             and molded.dtype == torch.uint8)):
                mean = np.asarray(self.config.MEAN_PIXEL, np.float32)
                if isinstance(molded, torch.Tensor):
                    molded = molded.cpu().numpy()
                molded = np.clip(np.rint(np.asarray(molded, np.float32)
                                         + mean), 0, 255).astype(np.uint8)
            if self.qmodel.act_scales is None:
                self.qmodel.calibrate(molded)
            return self.qmodel(molded)
        x = molded if isinstance(molded, torch.Tensor) \
            else torch.from_numpy(np.ascontiguousarray(molded))
        x = x.to(self.device, torch.float32).permute(0, 3, 1, 2)
        with torch.no_grad():
            return self.model(x)

    def mold_inputs(self, images: Sequence[np.ndarray]):
        """Pad + mean-subtract + meta for images at the network
        resolution. Returns (molded [B,H,W,3] f32, metas, windows)."""
        cfg = self.config
        molded, metas, windows = [], [], []
        for image in images:
            h, w = image.shape[:2]
            (oh, ow), window, scale = resize_geometry(
                h, w, cfg.IMAGE_MIN_DIM, cfg.IMAGE_MAX_DIM,
                cfg.IMAGE_MIN_SCALE, cfg.IMAGE_RESIZE_MODE)
            if scale != 1 or cfg.IMAGE_RESIZE_MODE == 'crop':
                raise NotImplementedError(
                    f'a {h}x{w} image needs resampling to the network '
                    'resolution; the image resampler is not ported')
            top, left = window[0], window[1]
            pad = [(top, oh - h - top), (left, ow - w - left)]
            pad += [(0, 0)] * (image.ndim - 2)
            m = np.pad(image, pad, mode='constant', constant_values=0)
            molded.append(mold_image(m, cfg))
            metas.append(compose_image_meta(0, image.shape, m.shape, window,
                                            scale))
            windows.append(window)
        return np.stack(molded), np.stack(metas), np.stack(windows)

    def detect(self, images: Sequence[np.ndarray]) -> List[dict]:
        """Per-image raw head outputs for a batch of BATCH_SIZE images."""
        cfg = self.config
        if len(images) != cfg.BATCH_SIZE:
            raise ValueError(f'len(images) must equal BATCH_SIZE '
                             f'({cfg.BATCH_SIZE}), got {len(images)}')
        molded, _, _ = self.mold_inputs(images)
        outputs = {k: v.cpu().numpy()
                   for k, v in self.predict_molded(molded).items()}
        if cfg.REGRESS_KEYPOINTS:
            raise NotImplementedError('keypoint heads are not ported')
        return [{'loc': outputs['loc'][i], 'ori': outputs['ori'][i]}
                for i in range(len(images))]
