"""Device selection for the port's entry points.

Every entry point takes `device`, defaulting to 'cuda'. The CPU runs the
plain PyTorch versions of the kernels, and only when the caller names
it; there is no silent fallback from the card to the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """Return `torch.device(device)`; raise if it names CUDA and no card
    is visible."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available; pass "
            "device='cpu' explicitly to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev


def check_on(module: torch.nn.Module, dev: torch.device) -> None:
    """Raise unless every parameter of `module` lies on `dev`."""
    for name, p in module.named_parameters():
        if p.device.type != dev.type:
            raise ValueError(
                f"parameter {name} is on {p.device}, the step runs on {dev}")
