"""Configuration (the port's own copy of `ursonet_tpu/config.py`).

Same knob names and derived-field semantics as the JAX package, so one
configuration reads the same in both: attributes are set after
construction and `update()` recomputes the derived fields
(BATCH_SIZE, IMAGE_SHAPE, IMAGE_META_SIZE). Knobs that only steered the
TPU build (mesh shape, Pallas switch) are left out; a later slice adds
the ones it needs. A configuration written by `write_to_file` in either
package reads back in the other through `from_dict`. numpy only.
"""

from __future__ import annotations

import json
import os

import numpy as np


class Config:
    """Base configuration. Override attributes, then call `update()`."""

    NAME = "ursonet"

    # --- batch ---------------------------------------------------------------
    GPU_COUNT = 1
    IMAGES_PER_GPU = 2

    # --- training schedule (UrsoNet.train) ----------------------------------
    STEPS_PER_EPOCH = 1000
    VALIDATION_STEPS = 50

    # --- model ----------------------------------------------------------------
    BACKBONE = "resnet101"          # resnet50 | resnet101
    BOTTLENECK_WIDTH = 128
    BRANCH_SIZE = 1024
    NR_DENSE_LAYERS = 1
    # the stem as its exact space-to-depth rewrite (4×4/1 over 12 channels)
    STEM_SPACE_TO_DEPTH = False

    # --- input resizing ---------------------------------------------------------
    IMAGE_RESIZE_MODE = "pad64"     # none | square | pad64 | crop
    IMAGE_MIN_DIM = 480
    IMAGE_MAX_DIM = 512
    IMAGE_MIN_SCALE = 0
    NR_IMAGE_CHANNELS = 3
    MEAN_PIXEL = np.array([123.7, 116.8, 103.9])

    # --- optimisation -------------------------------------------------------------
    LEARNING_RATE = 0.001
    LEARNING_MOMENTUM = 0.9
    CLR = False                     # cyclical LR: a later slice
    OPTIMIZER = 'SGD'               # SGD | ADAM
    WEIGHT_DECAY = 0.0001
    GRADIENT_CLIP_NORM = 5.0

    # --- heads / pose parameterisation ---------------------------------------------
    REGRESS_ORI = True
    REGRESS_LOC = True
    REGRESS_KEYPOINTS = False
    ORIENTATION_PARAM = 'quaternion'  # quaternion | euler_angles | angle_axis
    LOC_BINS_PER_DIM = 16
    ORI_BINS_PER_DIM = 32
    BETA = 6.0

    # --- augmentation ----------------------------------------------------------------
    ROT_AUG = True                  # camera-rotation homography warp
    SIM2REAL_AUG = False
    ROT_IMAGE_AUG = False           # in-plane roll warp
    WARP_INTERPOLATION = 'nearest'  # nearest | bilinear
    # The host only decodes, resizes and batches uint8 frames; the
    # augmentation and the mold run on the device. False (the host-parity
    # generator) raises in data/loader.py: a later slice ports it.
    AUGMENT_ON_DEVICE = True
    # The JAX package's native C++ batch loader. Read, and the port's
    # loader says once that it takes the Python path (data/loader.py).
    NATIVE_LOADER = True
    # Keep small datasets resident on the device: one bulk upload, then
    # each batch is an index gather on the card. True | False | 'auto'
    # ('auto' sizes the dataset against DATA_ON_DEVICE_MAX_MB).
    DATA_ON_DEVICE = 'auto'
    DATA_ON_DEVICE_MAX_MB = 1024

    # --- precision -----------------------------------------------------------------
    F16 = False

    # Recompute residual blocks in the backward pass
    # (torch.utils.checkpoint): trades FLOPs for activation memory.
    #   False      no recompute
    #   True/'all' the whole block is recomputed (nothing saved inside it)
    #   'narrow'   the narrow f1/f2-wide part runs outside the recompute;
    #              the backward re-runs the 1x1 expansion, its BN, the
    #              shortcut and the join, never the 3x3 conv. It keeps four
    #              f1-wide tensors a block: the 2a and 2b ReLU outputs (all
    #              the JAX policy saves) and the 2a and 2b conv outputs,
    #              which the BN affine gradients read
    #   'dots'     the JAX package's checkpoint_dots policy, which for a
    #              conv net degenerates to 'all'
    # Gradients are identical across policies.
    REMAT = False

    # --- int8 PTQ serving (models/quant.py) -------------------------------------------
    # INT8_U8_INPUT ships served batches as raw uint8 pixels and folds the
    # mean-subtract into the input quantize. The QUANT_* knobs are the JAX
    # package's serving ablations. QUANT_STEM_S2D rewrites the 7×7/2 stem
    # exactly into its 4×4/1 space-to-depth form at quantization time
    # (needs even H and W); QUANT_HOST_S2D also ships served and
    # calibration batches already packed ([B,H/2,W/2,12], a numpy
    # reindex on the host). Under either a uint8 batch runs the fused
    # stem kernel (ops/int8_cuda.py::stem_s8). QUANT_FLOAT_* are read,
    # checked against artifacts and served; QUANT_BF16_STEM and
    # QUANT_S8_JOIN raise NotImplementedError.
    INT8_U8_INPUT = True
    QUANT_STEM_S2D = False
    QUANT_HOST_S2D = False
    QUANT_BF16_STEM = False
    QUANT_S8_JOIN = False
    QUANT_FLOAT_CLS_FINAL = False
    QUANT_FLOAT_REG_HEAD = False

    # --- losses --------------------------------------------------------------------
    LEARNABLE_LOSS_WEIGHTS = False
    LOSS_WEIGHTS = {
        "loc_loss": 1.,
        "ori_loss": 1.,
        "k2_loss": 1.,
        "k3_loss": 1.
    }

    # --- batch norm ------------------------------------------------------------------
    #  None: train BN layers   False: freeze (use running stats)   True: don't use
    TRAIN_BN = False

    SEED = 0
    # Per-step scalar logging to metrics.jsonl every N steps (0 = per
    # epoch only).
    LOG_EVERY_STEPS = 0
    CHECKPOINT_FORMAT = 'msgpack'   # msgpack ('orbax' is not ported)
    # Keep only the newest N per-epoch weight snapshots (0 = keep all);
    # state_latest.msgpack always remains.
    CHECKPOINT_KEEP = 0

    def update(self):
        """Recompute derived fields."""
        self.BATCH_SIZE = self.IMAGES_PER_GPU * self.GPU_COUNT
        if self.IMAGE_RESIZE_MODE == "crop":
            self.IMAGE_SHAPE = np.array(
                [self.IMAGE_MIN_DIM, self.IMAGE_MIN_DIM, self.NR_IMAGE_CHANNELS])
        elif self.IMAGE_RESIZE_MODE == "pad64":
            # Assumes wide images
            self.IMAGE_SHAPE = np.array(
                [self.IMAGE_MIN_DIM, self.IMAGE_MAX_DIM, self.NR_IMAGE_CHANNELS])
        else:
            self.IMAGE_SHAPE = np.array(
                [self.IMAGE_MAX_DIM, self.IMAGE_MAX_DIM, self.NR_IMAGE_CHANNELS])
        # meta = id(1) + original_shape(3) + shape(3) + window(4) + scale(1)
        self.IMAGE_META_SIZE = 1 + self.NR_IMAGE_CHANNELS + 3 + 4 + 1

    def __init__(self):
        self.update()

    # -- introspection ------------------------------------------------------

    def display(self):
        """Print all configuration values."""
        print("\nConfigurations:")
        for a in dir(self):
            if not a.startswith("__") and not callable(getattr(self, a)):
                print("{:30} {}".format(a, getattr(self, a)))
        print("\n")

    def to_dict(self) -> dict:
        """Every non-callable attribute but the numpy arrays
        (MEAN_PIXEL, IMAGE_SHAPE), as the JAX package writes them."""
        d = {}
        for a in dir(self):
            v = getattr(self, a)
            if a.startswith("__") or callable(v) or isinstance(v, np.ndarray):
                continue
            d[a] = v
        return d

    def write_to_file(self, filepath):
        """Persist as JSON."""
        directory = os.path.dirname(filepath)
        if directory:
            os.makedirs(directory, exist_ok=True)
        with open(filepath, 'w+') as f:
            f.write(json.dumps(self.to_dict(), default=str))

    @classmethod
    def from_dict(cls, d):
        cfg = cls()
        for k, v in d.items():
            setattr(cfg, k, v)
        cfg.update()
        return cfg

    def head_input_features(self) -> int:
        """Flattened feature count after the stride-2 bottleneck conv."""
        return int(self.BOTTLENECK_WIDTH * self.IMAGE_SHAPE[0] *
                   self.IMAGE_SHAPE[1] / (64 ** 2))
