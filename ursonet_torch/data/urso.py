"""URSO dataset adapter, the counterpart of `ursonet_tpu/data/urso.py`.

Reads `{subset}_images.csv` (one file name a line) and
`{subset}_poses_gt.csv` (header x,y,z,q1,q2,q3,q4) with the `csv`
module, flips each quaternion into the north hemisphere (q4 >= 0),
precomputes every pose parameterization and, in classification mode,
the orientation and location soft-assignment maps, vectorized.
"""

from __future__ import annotations

import csv
import os

import numpy as np

from ursonet_torch import se3
from ursonet_torch.data.dataset import Dataset
from ursonet_torch.ops import encoders


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


# Dataset pixel mean (unused by default, kept for parity)
MEAN_PIXEL = np.array([45, 49, 52])

POSE_COLUMNS = ('x', 'y', 'z', 'q1', 'q2', 'q3', 'q4')


def _read_names(path: str) -> list:
    with open(path, newline='') as f:
        return [row[0] for row in csv.reader(f) if row]


def _read_poses(path: str) -> np.ndarray:
    """[N, 7] float64 in POSE_COLUMNS order, by header name."""
    with open(path, newline='') as f:
        rows = list(csv.DictReader(f))
    return np.array([[float(r[c]) for c in POSE_COLUMNS] for r in rows],
                    np.float64).reshape(len(rows), len(POSE_COLUMNS))


class Urso(Dataset):

    def load_dataset(self, dataset_dir, config, subset):
        """Load a subset ('train', 'val', 'test')."""
        self.name = 'Urso'
        if not os.path.exists(dataset_dir):
            print(f"Image directory '{dataset_dir}' not found.")
            return None
        rgb_list = _read_names(os.path.join(dataset_dir,
                                            subset + '_images.csv'))
        self.camera = Camera()
        poses = _read_poses(os.path.join(dataset_dir,
                                         subset + '_poses_gt.csv'))
        nr_instances = len(rgb_list)

        q_raw = poses[:nr_instances, 3:7].astype(np.float32)
        sign = np.where(q_raw[:, 3:4] < 0, -1.0, 1.0).astype(np.float32)
        q_array = q_raw * sign
        t_array = poses[:nr_instances, 0:3].astype(np.float32)

        ori_encoded = None
        if not config.REGRESS_ORI:
            print('URSO: precomputing orientation soft-assignment PMFs')
            ori_encoded, ori_histogram_map, ori_output_mask = \
                encoders.encode_ori(q_array, config.ORI_BINS_PER_DIM,
                                    config.BETA, np.array([-180, -90, -180]),
                                    np.array([180, 90, 180]))
            self.ori_histogram_map = ori_histogram_map
            self.ori_output_mask = ori_output_mask

        loc_encoded = None
        if not config.REGRESS_LOC:
            print('URSO: precomputing location soft-assignment PMFs')
            # (image_x, image_y, depth) from the Unreal frame
            img_x = t_array[:, 1] / t_array[:, 0]
            img_y = t_array[:, 2] / t_array[:, 0]
            z = t_array[:, 0]
            # the reference halves the FOV twice (radians × π/360): kept
            theta_x = self.camera.fov_x * np.pi / 360
            theta_y = self.camera.fov_y * np.pi / 360
            x_max = np.tan(theta_x)
            y_max = np.tan(theta_y)
            loc_encoded, loc_histogram_map = encoders.encode_loc(
                np.stack((img_x, img_y, z), axis=1),
                config.LOC_BINS_PER_DIM, config.BETA,
                np.array([-x_max, -y_max, z.min()]),
                np.array([x_max, y_max, z.max()]))
            self.histogram_3D_map = loc_histogram_map

        if not rgb_list:
            print('No files found')
            return None

        # virtual 3D keypoints at URSO's scale of 3 m
        K1, K2 = encode_as_keypoints(q_array, t_array, 3.0)
        for i, file_name in enumerate(rgb_list):
            q = q_array[i, :]
            v, theta = se3.quat2angleaxis(q)
            self.add_image(
                "URSO",
                image_id=i,
                path=os.path.join(dataset_dir, file_name),
                keypoints=[K1[i, :], K2[i, :]],
                location=t_array[i, :],
                location_map=[] if config.REGRESS_LOC else loc_encoded[i, :],
                quaternion=q,
                angleaxis=np.asarray(v) * theta,
                pyr=np.asarray(se3.quat2euler(q)),
                ori_map=[] if config.REGRESS_ORI else ori_encoded[i, :],
            )
        self.num_images = len(self.image_info)
        self._image_ids = np.arange(self.num_images)


def encode_as_keypoints(oris, centroids, scale=1.0):
    """The pose as two virtual 3D keypoints, K1 = R·s·[0,0,1] + c and
    K2 = R·s·[0,1,0] + c, float32 [N, 3] each."""
    oris = np.atleast_2d(np.asarray(oris, np.float64))
    centroids = np.atleast_2d(np.asarray(centroids, np.float64))
    n = oris.shape[0]
    K1 = np.zeros((n, 3), np.float32)
    K2 = np.zeros((n, 3), np.float32)
    for i in range(n):
        R = se3.quat2SO3(oris[i])
        c = centroids[i]
        K1[i] = (R @ (scale * np.array([0.0, 0.0, 1.0]))) + c
        K2[i] = (R @ (scale * np.array([0.0, 1.0, 0.0]))) + c
    return K1, K2
