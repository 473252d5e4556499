"""Named configuration presets (the port's own copy of
`ursonet_tpu/presets.py::benchmark_config`).

`benchmark_config(n)` returns a fresh `Config` with `update()` applied
for the five benchmark configurations of BASELINE.md. The port trains
configurations 2 (ResNet-18, quaternion regression, batch 1), 3 (also
under F16), 4 (SPEED, sim2real, cyclical LR) and 5 (ResNet-101, F16,
keypoints, REMAT), and serves 1 and 2. `released_config(name)`
matches the released reference weights (their h5 files are not in the
repo). `serving_config(batch)` is the flagship int8 serving
configuration that `bench.py` times (F16).
"""

from __future__ import annotations

from ursonet_torch.config import Config

_URSO_WH = (1280, 960)
_SPEED_WH = (1920, 1200)


def _apply(cfg: Config, scale: float, camera_wh) -> Config:
    """IMAGE_MIN/MAX_DIM from an image scale, as the CLI derives them."""
    w0, h0 = camera_wh
    cfg.IMAGE_MAX_DIM = round(w0 * scale)
    h = round(h0 * scale)
    cfg.IMAGE_MIN_DIM = h - h % 64 + 64 if h % 64 else h
    cfg.update()
    return cfg


def benchmark_config(n: int) -> Config:
    """BASELINE.md benchmark configs 1-5."""
    cfg = Config()
    if n == 1:
        # ResNet-50 single-image inference on soyuz_easy, scale 0.5
        cfg.NAME = 'soyuz_easy'
        cfg.BACKBONE = 'resnet50'
        cfg.BOTTLENECK_WIDTH = 128
        cfg.REGRESS_LOC = True
        cfg.REGRESS_ORI = False
        cfg.ORI_BINS_PER_DIM = 16
        cfg.IMAGES_PER_GPU = 1
        cfg.IMAGE_RESIZE_MODE = 'pad64'
        return _apply(cfg, 0.5, _URSO_WH)
    if n == 2:
        # ResNet-18 quaternion regression eval on soyuz_easy val
        cfg.NAME = 'soyuz_easy'
        cfg.BACKBONE = 'resnet18'
        cfg.BOTTLENECK_WIDTH = 32
        cfg.REGRESS_LOC = True
        cfg.REGRESS_ORI = True
        cfg.ORIENTATION_PARAM = 'quaternion'
        cfg.IMAGES_PER_GPU = 1
        cfg.IMAGE_RESIZE_MODE = 'pad64'
        return _apply(cfg, 0.5, _URSO_WH)
    if n == 3:
        # ResNet-50 orientation soft-classification training on soyuz_easy
        cfg.NAME = 'soyuz_easy'
        cfg.BACKBONE = 'resnet50'
        cfg.BOTTLENECK_WIDTH = 128
        cfg.REGRESS_LOC = True
        cfg.REGRESS_ORI = False
        cfg.ORI_BINS_PER_DIM = 24
        cfg.ROT_AUG = True
        cfg.ROT_IMAGE_AUG = True
        cfg.IMAGES_PER_GPU = 4
        cfg.IMAGE_RESIZE_MODE = 'pad64'
        return _apply(cfg, 0.5, _URSO_WH)
    if n == 4:
        # SPEED training with sim2real + cyclical LR
        cfg.NAME = 'speed'
        cfg.BACKBONE = 'resnet50'
        cfg.BOTTLENECK_WIDTH = 128
        cfg.REGRESS_LOC = True
        cfg.REGRESS_ORI = False
        cfg.ORI_BINS_PER_DIM = 16
        cfg.SIM2REAL_AUG = True
        cfg.CLR = True
        cfg.IMAGES_PER_GPU = 4
        cfg.IMAGE_RESIZE_MODE = 'pad64'
        return _apply(cfg, 0.5, _SPEED_WH)
    if n == 5:
        # ResNet-101 bf16 large-batch DP training on soyuz_hard with the
        # experimental 3-keypoint head
        cfg.NAME = 'soyuz_hard'
        cfg.BACKBONE = 'resnet101'
        cfg.BOTTLENECK_WIDTH = 128
        cfg.REGRESS_KEYPOINTS = True
        cfg.F16 = True
        cfg.IMAGES_PER_GPU = 16
        cfg.REMAT = True
        cfg.IMAGE_RESIZE_MODE = 'pad64'
        return _apply(cfg, 0.5, _URSO_WH)
    raise ValueError(f"unknown benchmark config {n} (1-5)")


def released_config(name: str) -> Config:
    """The configurations of the released reference weights
    ('soyuz_hard', 'dragon_hard', 'speed'): square resize, batch 1."""
    cfg = Config()
    cfg.NAME = name
    cfg.IMAGE_RESIZE_MODE = 'square'
    cfg.IMAGES_PER_GPU = 1
    if name in ('soyuz_hard', 'dragon_hard'):
        cfg.BACKBONE = 'resnet50'
        cfg.BOTTLENECK_WIDTH = 128
        cfg.REGRESS_LOC = True
        cfg.REGRESS_ORI = False
        cfg.ORI_BINS_PER_DIM = 24
        return _apply(cfg, 0.5, _URSO_WH)
    if name == 'speed':
        cfg.BACKBONE = 'resnet101'
        cfg.BOTTLENECK_WIDTH = 528
        cfg.REGRESS_LOC = True
        cfg.REGRESS_ORI = False
        cfg.ORI_BINS_PER_DIM = 32
        cfg.F16 = True
        return _apply(cfg, 0.5, _SPEED_WH)
    raise ValueError(f"unknown released model {name}")


SERVING_VARIANTS = ('base', 's2d', 'host_s2d')


def serving_config(batch: int = 128, variant: str = 'base',
                   f16: bool = True, inner_mult: float = 1.0,
                   s8_join: bool = False, bf16_stem: bool = False) -> Config:
    """The flagship int8 PTQ serving configuration: the one `bench.py`
    times and `tools/make_gate_artifact.py::flagship_gate_config` builds
    the committed artifact for. ResNet-50, bottleneck 128, one 1024-wide
    dense per head, location regression, 24³-bin orientation
    classification (int8 `ori_final` 1024→13824 with a ReLU), pad64 at
    512×640, uint8 input, F16 (bf16 epilogues; the bf16 float forward),
    every QUANT_* knob at its default.

    `variant` picks the stem as `tools/ab_serving.py` does: 'base' (the
    7×7/2 stem), 's2d' (QUANT_STEM_S2D: the exact 4×4/1 rewrite, the
    device packs the pixels) or 'host_s2d' (QUANT_STEM_S2D +
    QUANT_HOST_S2D: the host packs them). Under the last two a uint8
    batch runs the fused stem kernel.

    `f16=False` gives the f32-epilogue mode of the same artifact (F16 is
    not recorded in it): the int8 epilogues in f32 with one FMA.

    The ablation knobs `bench.py` reads from its environment:
    `inner_mult` (BENCH_INNER_MULT: INNER_WIDTH_MULT, the pruned-width
    flagship), `s8_join` (BENCH_S8_JOIN: QUANT_S8_JOIN) and `bf16_stem`
    (BENCH_BF16_STEM: QUANT_BF16_STEM)."""
    if variant not in SERVING_VARIANTS:
        raise ValueError(f"unknown serving variant {variant!r} "
                         f"{SERVING_VARIANTS}")
    cfg = Config()
    cfg.NAME = 'flagship_serving'
    cfg.QUANT_STEM_S2D = variant in ('s2d', 'host_s2d')
    cfg.QUANT_HOST_S2D = variant == 'host_s2d'
    cfg.BACKBONE = 'resnet50'
    cfg.BOTTLENECK_WIDTH = 128
    cfg.BRANCH_SIZE = 1024
    cfg.NR_DENSE_LAYERS = 1
    cfg.REGRESS_LOC = True
    cfg.REGRESS_ORI = False
    cfg.ORI_BINS_PER_DIM = 24
    cfg.IMAGE_RESIZE_MODE = 'pad64'
    cfg.IMAGE_MIN_DIM = 512
    cfg.IMAGE_MAX_DIM = 640
    cfg.IMAGES_PER_GPU = batch
    cfg.INT8_U8_INPUT = True
    cfg.F16 = bool(f16)
    cfg.INNER_WIDTH_MULT = float(inner_mult)
    cfg.QUANT_S8_JOIN = bool(s8_join)
    cfg.QUANT_BF16_STEM = bool(bf16_stem)
    cfg.update()
    return cfg
