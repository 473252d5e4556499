"""Dataset base class, the counterpart of `ursonet_tpu/data/dataset.py`:
an in-memory image index whose entries carry the pose in every
parameterization and the precomputed soft-assignment maps.

`load_image_rgb` decodes PNG frames with the port's own codec
(`data/png.py`); a JPEG frame raises NotImplementedError until the
native-loader slice brings a JPEG decoder.
"""

from __future__ import annotations

import numpy as np

from ursonet_torch.data.png import SIGNATURE, decode_png

_JPEG_SOI = b'\xff\xd8'


def load_image_rgb(path: str) -> np.ndarray:
    """Read an image file as [H, W, 3] uint8 (RGB): grayscale replicated
    to three channels, alpha dropped."""
    with open(path, 'rb') as f:
        data = f.read()
    if data.startswith(SIGNATURE):
        arr = decode_png(data)
    elif data.startswith(_JPEG_SOI):
        raise NotImplementedError(
            f'{path}: JPEG frames are decoded by the native-loader slice '
            '(ROADMAP §1); the port reads PNG only')
    else:
        raise ValueError(f'{path}: neither PNG nor JPEG')
    if arr.ndim == 2:
        arr = np.repeat(arr[:, :, None], 3, axis=2)
    if arr.shape[-1] == 4:
        arr = arr[..., :3]
    return arr


class Dataset:
    def __init__(self):
        self._image_ids = []
        self.image_info = []
        self.name = 'Dataset'
        self.camera = None
        # Classification-mode structures, populated by adapters:
        self.ori_histogram_map = None   # (bins³, 4) bin quaternions
        self.ori_output_mask = None     # (bins³,) redundant-bin mask
        self.histogram_3D_map = None    # (bins³, 3) location bin XYZ

    def add_image(self, source, image_id, path, **kwargs):
        info = {"id": image_id, "source": source, "path": path}
        info.update(kwargs)
        self.image_info.append(info)

    @property
    def image_ids(self):
        return self._image_ids

    def load_image(self, image_id):
        return load_image_rgb(self.image_info[image_id]['path'])

    def load_location(self, image_id):
        return self.image_info[image_id]["location"]

    def load_keypoints(self, image_id):
        return self.image_info[image_id]["keypoints"]

    def load_quaternion(self, image_id):
        return self.image_info[image_id]["quaternion"]

    def load_euler_angles(self, image_id):
        return self.image_info[image_id]["pyr"]

    def load_angle_axis(self, image_id):
        return self.image_info[image_id]["angleaxis"]

    def load_location_encoded(self, image_id):
        return self.image_info[image_id]["location_map"]
