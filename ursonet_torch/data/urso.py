"""URSO camera (the port's copy of `ursonet_tpu/data/urso.py::Camera`).

The file-based URSO dataset adapter waits for a later slice of the port.
"""

from __future__ import annotations

import numpy as np


class Camera:
    """URSO render camera: 90°×73.7° FOV, 1280×960, negative fy (the
    renderer's y-down convention)."""
    fov_x = 90.0 * np.pi / 180
    fov_y = 73.7 * np.pi / 180
    width = 1280
    height = 960
    fx = width / (2 * np.tan(fov_x / 2))
    fy = -height / (2 * np.tan(fov_y / 2))
    K = np.array([[fx, 0, width / 2], [0, fy, height / 2], [0, 0, 1]])
