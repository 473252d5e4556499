"""Configuration (the port's own copy of `ursonet_tpu/config.py`).

Same knob names and derived-field semantics as the JAX package, so one
configuration reads the same in both: attributes are set after
construction and `update()` recomputes the derived fields
(BATCH_SIZE, IMAGE_SHAPE, IMAGE_META_SIZE). Knobs that only steered the
TPU build (mesh shape, Pallas switch, remat, host loader) are left out;
a later slice adds the ones it needs. numpy only.
"""

from __future__ import annotations

import numpy as np


class Config:
    """Base configuration. Override attributes, then call `update()`."""

    NAME = "ursonet"

    # --- batch ---------------------------------------------------------------
    GPU_COUNT = 1
    IMAGES_PER_GPU = 2

    # --- model ----------------------------------------------------------------
    BACKBONE = "resnet101"          # this port builds resnet50 so far
    BOTTLENECK_WIDTH = 128
    BRANCH_SIZE = 1024
    NR_DENSE_LAYERS = 1

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

    # --- precision -----------------------------------------------------------------
    F16 = False

    # --- int8 PTQ serving (models/quant.py) -------------------------------------------
    # INT8_U8_INPUT ships served batches as raw uint8 pixels and folds the
    # mean-subtract into the input quantize. The QUANT_* knobs are the JAX
    # package's serving ablations; this port serves their defaults and
    # raises NotImplementedError for the others (QUANT_FLOAT_* are read,
    # checked against artifacts and served).
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

    def head_input_features(self) -> int:
        """Flattened feature count after the stride-2 bottleneck conv."""
        return int(self.BOTTLENECK_WIDTH * self.IMAGE_SHAPE[0] *
                   self.IMAGE_SHAPE[1] / (64 ** 2))
