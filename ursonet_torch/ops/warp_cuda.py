"""Batched homography warp: build, load and call the CUDA kernel
`ursonet_torch/csrc/warp.cu` (the port of the Pallas TPU kernel
`ursonet_tpu/ops/warp_pallas.py::_kernel`).

`warp_mold(src, Ms, identity, mean, interpolation)` is the fused mode the
on-device preprocess runs: for each image the source as it is
(`identity`) or warped by its dst←src homography (cv2 WARP_INVERSE_MAP
semantics), minus the mean pixel, as a fresh f32 [B,3,H,W]. `src` is the
raw u8 batch [B,H,W,3] or, after sim2real, the gray f32 plane [B,1,H,W]
(every channel samples it). `warp_cuda(images, Ms, interpolation)` is
the unfused mode: [B,C,H,W] f32 images warped, nothing else;
`warp_cuda_gray` warps channel 0 only and broadcasts it to all channels.

On a CUDA tensor the wrappers launch the kernel on the tensor's device,
and a failed build or launch, or an input the kernel does not take,
raises; on a CPU tensor they run the plain PyTorch versions in
`ursonet_torch/ops/augment.py` (`warp_mold_torch`, `warp_nearest_torch`,
`warp_bilinear_torch`).

The kernel is built and loaded by `ops/cuda_build.py` (nvcc for sm_90a
at first use, ctypes). Each launch adds one to
`launches["warp_homography"]`; a launch that samples one gray plane
(`warp_cuda_gray`, `warp_mold` from a gray plane) adds one to
`launches["warp_homography_gray"]` too, a fused launch (`warp_mold`) one
to `launches["warp_mold"]`.

`warp_mold(..., stats=t)` with an int32 CUDA tensor `t` of 2 elements
adds to t[0] the launch's tiles whose taps were read from global memory
(their source box did not fit, or TMA cannot address the source) and to
t[1] its tiles (32x32 output pixels each).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ursonet_torch.ops import cuda_build

INTERPOLATIONS = {"nearest": 0, "bilinear": 1}
SRC_U8_RGB, SRC_F32 = 0, 1
TILE = 32        # output tile side (csrc/warp.cu kTile)

# Kernel launches since the last reset_counts(), by kernel name.
launches = {"warp_homography": 0, "warp_homography_gray": 0, "warp_mold": 0}


def reset_counts() -> None:
    for k in launches:
        launches[k] = 0


def _bind(lib) -> None:
    fn = lib.ursonet_warp
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.ursonet_cuda_error_string.argtypes = [ctypes.c_int]
    lib.ursonet_cuda_error_string.restype = ctypes.c_char_p


def load() -> ctypes.CDLL:
    """Build if needed and load the kernel library (once per process)."""
    return cuda_build.load("warp", _bind)


def tma_addressable(src: torch.Tensor) -> bool:
    """Whether the kernel's tensor map addresses `src` (a row pitch that
    is a multiple of 16 bytes and a 16-byte aligned base); otherwise every
    tile reads its taps from global memory."""
    row = src.shape[-2] * 3 if src.dtype == torch.uint8 else src.shape[-1] * 4
    return row % 16 == 0 and src.data_ptr() % 16 == 0


def _check_ms(Ms: torch.Tensor, b: int, dev: torch.device) -> None:
    if Ms.shape != (b, 3, 3) or Ms.dtype != torch.float32 \
            or not Ms.is_contiguous() or Ms.device != dev:
        raise ValueError("Ms must be a contiguous [B,3,3] float32 tensor on "
                         f"{dev}, got {tuple(Ms.shape)} {Ms.dtype} on "
                         f"{Ms.device}")


def _call(src, kind, Ms, identity, mean, out, stats, c_in, c_out, gray,
          interpolation) -> None:
    """Launch on `src`'s device and stream; raise on a refused launch."""
    lib = load()
    dev = src.device
    b, h, w = out.shape[0], out.shape[2], out.shape[3]
    mean_ptr = None if mean is None else mean.ctypes.data
    args = (src.data_ptr(), kind, Ms.data_ptr(),
            None if identity is None else identity.data_ptr(), mean_ptr,
            out.data_ptr(), None if stats is None else stats.data_ptr(),
            b, c_in, c_out, h, w, int(gray), int(identity is not None),
            INTERPOLATIONS[interpolation],
            torch.cuda.current_stream(dev).cuda_stream)
    if torch.cuda.current_device() == dev.index:
        rc = lib.ursonet_warp(*args)
    else:
        with torch.cuda.device(dev):
            rc = lib.ursonet_warp(*args)
    if rc != 0:
        raise RuntimeError("warp_homography launch failed: "
                           + lib.ursonet_cuda_error_string(rc).decode())
    launches["warp_homography"] += 1
    if gray:
        launches["warp_homography_gray"] += 1


def _launch(images: torch.Tensor, Ms: torch.Tensor, interpolation: str,
            c_out: int, gray: bool = False) -> torch.Tensor:
    if interpolation not in INTERPOLATIONS:
        raise ValueError(f"unknown interpolation {interpolation!r}")
    if images.dim() != 4 or images.dtype != torch.float32 \
            or not images.is_contiguous():
        raise ValueError("images must be a contiguous [B,C,H,W] float32 "
                         f"tensor, got {tuple(images.shape)} {images.dtype}")
    b, c, h, w = images.shape
    _check_ms(Ms, b, images.device)
    out = torch.empty((b, c_out, h, w), dtype=torch.float32,
                      device=images.device)
    if out.numel() == 0:
        return out
    _call(images, SRC_F32, Ms, None, None, out, None, c, c_out, gray,
          interpolation)
    return out


def _plain(interpolation: str):
    from ursonet_torch.ops import augment
    if interpolation == "nearest":
        return augment.warp_nearest_torch
    if interpolation == "bilinear":
        return augment.warp_bilinear_torch
    raise ValueError(f"unknown interpolation {interpolation!r}")


def _check_device(images: torch.Tensor) -> None:
    if images.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {images.device}")


def warp_cuda(images: torch.Tensor, Ms: torch.Tensor,
              interpolation: str = "nearest") -> torch.Tensor:
    """Warp images [B,C,H,W] f32 by homographies Ms [B,3,3] f32."""
    _check_device(images)
    if images.device.type == "cpu":
        return _plain(interpolation)(images, Ms)
    return _launch(images, Ms, interpolation, images.shape[1])


def warp_cuda_gray(images: torch.Tensor, Ms: torch.Tensor,
                   interpolation: str = "nearest") -> torch.Tensor:
    """Grayscale-replicated batches: warp channel 0, broadcast to all C
    channels (a view of one [B,1,H,W] result). `images` may itself be a
    broadcast view of one channel."""
    _check_device(images)
    if images.device.type == "cpu":
        out = _plain(interpolation)(images[:, :1], Ms)
    else:
        src = images if images.is_contiguous() else \
            images[:, :1].contiguous()
        out = _launch(src, Ms, interpolation, 1, gray=True)
    return out.expand(images.shape)


def source_kind(src: torch.Tensor) -> int:
    """SRC_U8_RGB for a contiguous u8 [B,H,W,3] batch, SRC_F32 for a
    contiguous f32 [B,1,H,W] gray plane; ValueError for anything else."""
    if src.dim() == 4 and src.is_contiguous():
        if src.dtype == torch.uint8 and src.shape[3] == 3:
            return SRC_U8_RGB
        if src.dtype == torch.float32 and src.shape[1] == 1:
            return SRC_F32
    raise ValueError("warp_mold takes a contiguous u8 [B,H,W,3] batch or "
                     "a contiguous f32 [B,1,H,W] gray plane, got "
                     f"{tuple(src.shape)} {src.dtype} strides {src.stride()}")


def warp_mold(src: torch.Tensor, Ms: torch.Tensor, identity: torch.Tensor,
              mean, interpolation: str = "nearest",
              stats: torch.Tensor | None = None) -> torch.Tensor:
    """The fused preprocess: f32 [B,3,H,W] = (identity ? src : src warped
    by Ms) - mean. src: u8 [B,H,W,3] or f32 gray plane [B,1,H,W];
    identity: bool [B]; mean: 3 floats (the mean pixel, taken as
    float32)."""
    _check_device(src)
    if interpolation not in INTERPOLATIONS:
        raise ValueError(f"unknown interpolation {interpolation!r}")
    kind = source_kind(src)
    mean = np.ascontiguousarray(np.asarray(mean, np.float32).reshape(-1))
    if mean.shape != (3,):
        raise ValueError(f"mean must hold 3 values, got {mean.shape}")
    if src.device.type == "cpu":
        from ursonet_torch.ops import augment
        return augment.warp_mold_torch(src, Ms, identity, mean, interpolation)
    b = src.shape[0]
    h, w = (src.shape[1], src.shape[2]) if kind == SRC_U8_RGB \
        else (src.shape[2], src.shape[3])
    _check_ms(Ms, b, src.device)
    if identity.shape != (b,) or identity.dtype != torch.bool \
            or not identity.is_contiguous() or identity.device != src.device:
        raise ValueError(f"identity must be a bool [B] tensor on {src.device},"
                         f" got {tuple(identity.shape)} {identity.dtype} on "
                         f"{identity.device}")
    if stats is not None and (stats.shape != (2,) or stats.dtype != torch.int32
                              or stats.device != src.device):
        raise ValueError("stats must be an int32 [2] tensor on the source's "
                         "device")
    out = torch.empty((b, 3, h, w), dtype=torch.float32, device=src.device)
    if out.numel() == 0:
        return out
    _call(src, kind, Ms, identity, mean, out, stats,
          3 if kind == SRC_U8_RGB else 1, 3, kind == SRC_F32, interpolation)
    launches["warp_mold"] += 1
    return out
