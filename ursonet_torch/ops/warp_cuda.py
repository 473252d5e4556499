"""Batched homography warp: build, load and call the CUDA kernel
`ursonet_torch/csrc/warp.cu` (the port of the Pallas TPU kernel
`ursonet_tpu/ops/warp_pallas.py::_kernel`).

`warp_cuda(images, Ms, interpolation)` warps [B,C,H,W] f32 images by
per-image dst←src homographies Ms [B,3,3] (cv2 WARP_INVERSE_MAP
semantics). `warp_cuda_gray` warps channel 0 only and broadcasts it to
all channels. On a CUDA tensor the wrappers launch the kernel, and a
failed build or launch raises; on a CPU tensor they run the plain
PyTorch versions in `ursonet_torch/ops/augment.py`.

The kernel is built and loaded by `ops/cuda_build.py` (nvcc for sm_90a
at first use, ctypes). Each launch adds one to
`launches["warp_homography"]`.
"""

from __future__ import annotations

import ctypes

import torch

from ursonet_torch.ops import cuda_build

INTERPOLATIONS = {"nearest": 0, "bilinear": 1}

# Kernel launches since the last reset_counts(), by kernel name.
launches = {"warp_homography": 0}


def reset_counts() -> None:
    for k in launches:
        launches[k] = 0


def _bind(lib) -> None:
    fn = lib.ursonet_warp_homography
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.ursonet_cuda_error_string.argtypes = [ctypes.c_int]
    lib.ursonet_cuda_error_string.restype = ctypes.c_char_p


def load() -> ctypes.CDLL:
    """Build if needed and load the kernel library (once per process)."""
    return cuda_build.load("warp", _bind)


def _launch(images: torch.Tensor, Ms: torch.Tensor, interpolation: str,
            c_out: int) -> torch.Tensor:
    if interpolation not in INTERPOLATIONS:
        raise ValueError(f"unknown interpolation {interpolation!r}")
    if images.dim() != 4 or images.dtype != torch.float32 \
            or not images.is_contiguous():
        raise ValueError("images must be a contiguous [B,C,H,W] float32 "
                         f"tensor, got {tuple(images.shape)} {images.dtype}")
    b, c, h, w = images.shape
    if Ms.shape != (b, 3, 3) or Ms.dtype != torch.float32 \
            or not Ms.is_contiguous() or Ms.device != images.device:
        raise ValueError("Ms must be a contiguous [B,3,3] float32 tensor on "
                         f"{images.device}, got {tuple(Ms.shape)} {Ms.dtype} "
                         f"on {Ms.device}")
    out = torch.empty((b, c_out, h, w), dtype=torch.float32,
                      device=images.device)
    if out.numel() == 0:
        return out
    lib = load()
    stream = torch.cuda.current_stream(images.device).cuda_stream
    rc = lib.ursonet_warp_homography(
        images.data_ptr(), Ms.data_ptr(), out.data_ptr(), b, c, c_out, h, w,
        INTERPOLATIONS[interpolation], images.device.index, stream)
    if rc != 0:
        raise RuntimeError("warp_homography launch failed: "
                           + lib.ursonet_cuda_error_string(rc).decode())
    launches["warp_homography"] += 1
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
    channels (a view of one [B,1,H,W] result)."""
    _check_device(images)
    if images.device.type == "cpu":
        out = _plain(interpolation)(images[:, :1], Ms)
    else:
        out = _launch(images, Ms, interpolation, 1)
    return out.expand(images.shape)
