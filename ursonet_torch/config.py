"""Configuration (the port's own copy of `ursonet_tpu/config.py`).

Same knob names and derived-field semantics as the JAX package, so one
configuration reads the same in both: attributes are set after
construction and `update()` recomputes the derived fields
(BATCH_SIZE, IMAGE_SHAPE, IMAGE_META_SIZE, and GPU_COUNT from the mesh).
Knobs that only steered the TPU build (the Pallas switch) are left out;
a later slice adds the ones it needs. A configuration written by `write_to_file` in either
package reads back in the other through `from_dict`. numpy only.
"""

from __future__ import annotations

import json
import os

import numpy as np


class Config:
    """Base configuration. Override attributes, then call `update()`."""

    NAME = "ursonet"

    # --- batch and parallelism ---------------------------------------------
    # GPU_COUNT is the number of ranks, MESH_DATA x MESH_MODEL (update()
    # keeps them in step); IMAGES_PER_GPU is a data row's batch.
    GPU_COUNT = 1
    IMAGES_PER_GPU = 2
    # the (data, model) mesh of ranks (parallel/mesh.py): data-parallel
    # rows, tensor-parallel head denses
    MESH_DATA = 1
    MESH_MODEL = 1

    # --- training schedule (UrsoNet.train) ----------------------------------
    STEPS_PER_EPOCH = 1000
    VALIDATION_STEPS = 50

    # --- model ----------------------------------------------------------------
    BACKBONE = "resnet101"          # resnet18/34/50/101, hrnet_w32
    BOTTLENECK_WIDTH = 128
    BRANCH_SIZE = 1024
    NR_DENSE_LAYERS = 1
    # the stem as its exact space-to-depth rewrite (4×4/1 over 12 channels)
    STEM_SPACE_TO_DEPTH = False
    # The reduced-FLOP variant of the bottleneck backbones (ResNet-50/101):
    # every block's inner widths (f1, f2) scaled by this factor, rounded
    # to a multiple of 8 (models/resnet.py::scale_inner). Stream widths and
    # layer names stay, so a flagship checkpoint prunes into it by channel
    # selection (`python -m ursonet_torch.prune_inner`). ResNet-18/34 take
    # 1.0 only.
    INNER_WIDTH_MULT = 1.0

    # The landmark model (BACKBONE 'hrnet_w32', models/hrnet.py): one
    # heatmap a landmark at a quarter of the input's resolution, trained on
    # HRNet's Gaussian targets of HEATMAP_SIGMA heatmap pixels (ops/
    # landmarks.py) under JointsMSE. LANDMARKS: the body-frame landmarks,
    # NUM_LANDMARKS x 3 metres (None: ops/landmarks.py::default_landmarks).
    NUM_LANDMARKS = 11
    HEATMAP_SIGMA = 2.0
    LANDMARKS = None

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
    # cyclical LR (triangular, per update): BASE_LEARNING_RATE up to
    # MAX_LEARNING_RATE and back over 2 * CLR_STEP_SIZE updates
    CLR = False
    MAX_LEARNING_RATE = 0.0005
    BASE_LEARNING_RATE = 0.0001
    CLR_STEP_SIZE = 4000
    OPTIMIZER = 'SGD'               # SGD | ADAM (amsgrad)
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
    SIM2REAL_AUG = False            # gray + noise/blur/brightness/dropout
    # one sim2real op order per image (imgaug's random_order) instead of
    # one per batch; the magnitudes are per image either way
    SIM2REAL_PER_IMAGE_ORDER = False
    ROT_IMAGE_AUG = False           # in-plane roll warp
    WARP_INTERPOLATION = 'nearest'  # nearest | bilinear
    # The host only decodes, resizes and batches uint8 frames; the
    # augmentation and the mold run on the device. False: the host-parity
    # generator (the reference's per-image augmentation at the frame's own
    # resolution, then the resize and the mold, all on the host;
    # data/loader.py::load_image_gt).
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
    # Backbone convs whose backward reads an int8 copy of their input
    # (models/actq.py::ConvQ8): the forward and the input gradient stay
    # exact, the weight gradient sees 8-bit activations.
    #   False     plain convs
    #   True      weight gradient from the dequantized copy
    #   'wgrad8'  weight gradient as an int8 x int8 -> int32 product of the
    #             saved copy and an int8 output gradient (the hand-written
    #             `wgrad_s8`), where its worst case fits int32
    TRAIN_ACT_Q8 = False

    # --- int8 PTQ serving (models/quant.py) -------------------------------------------
    # INT8_U8_INPUT ships served batches as raw uint8 pixels and folds the
    # mean-subtract into the input quantize. The QUANT_* knobs are the JAX
    # package's serving ablations. QUANT_STEM_S2D rewrites the 7×7/2 stem
    # exactly into its 4×4/1 space-to-depth form at quantization time
    # (needs even H and W); QUANT_HOST_S2D also ships served and
    # calibration batches already packed ([B,H/2,W/2,12], a numpy
    # reindex on the host). Under either a uint8 batch runs the fused
    # stem kernel (ops/int8_cuda.py::stem_s8). QUANT_BF16_STEM molds the
    # pixels into bf16 and runs the stem conv in float over them (neither
    # the fused stem nor the input quantize runs); QUANT_S8_JOIN rounds
    # both operands of each residual join onto the output grid and joins
    # them as integers (gemm_s8 / conv_s8's join_s8 epilogue);
    # QUANT_FLOAT_* run the classification finals or the metric heads in
    # float. All are recorded in and checked against the int8 artifact.
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
    #  (None and True normalize with batch statistics in training and
    #  update the running ones; True also puts a BN after every hidden head
    #  dense, and int8 PTQ refuses it)
    TRAIN_BN = False

    SEED = 0
    # Per-step scalar logging to metrics.jsonl every N steps (0 = per
    # epoch only).
    LOG_EVERY_STEPS = 0
    CHECKPOINT_FORMAT = 'msgpack'   # msgpack | orbax
    # Keep only the newest N per-epoch weight snapshots (0 = keep all);
    # state_latest (.msgpack or .orbax) always remains.
    CHECKPOINT_KEEP = 0
    # Raise FloatingPointError at the first step whose losses, metrics or
    # updated weights hold a NaN (the JAX package's jax_debug_nans); costs
    # a host sync a step.
    DEBUG_NANS = False

    def update(self):
        """Recompute derived fields."""
        if self.TRAIN_ACT_Q8 not in (False, True, 'wgrad8'):
            raise ValueError(
                f"TRAIN_ACT_Q8 must be False, True, or 'wgrad8' "
                f"(got {self.TRAIN_ACT_Q8!r})")
        # ranks = data x model; without a mesh, GPU_COUNT ranks all go to
        # the data axis (BATCH_SIZE = IMAGES_PER_GPU x GPU_COUNT)
        if self.MESH_DATA * self.MESH_MODEL > 1:
            self.GPU_COUNT = self.MESH_DATA * self.MESH_MODEL
        else:
            self.MESH_DATA = self.GPU_COUNT
            self.MESH_MODEL = 1
        self.BATCH_SIZE = self.IMAGES_PER_GPU * self.MESH_DATA
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
