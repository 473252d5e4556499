"""SPEED (the ESA/Stanford Satellite Pose Estimation Dataset) adapter,
the counterpart of `ursonet_tpu/data/speed.py`.

Parses `{subset}.json`, converts each scalar-first `q_vbs2tango`
quaternion to the scalar-last convention with the north-hemisphere sign
fix, precomputes the orientation soft-assignment PMFs in classification
mode, the Euler and angle-axis forms and the two virtual keypoints, and,
for the unlabelled `test` / `real_test` subsets, keeps only the
bin->quaternion map the decode needs (with the all-False mask the JAX
package stores there). Frames are grayscale JPEGs under
`images/{train,test,real_test}` (`data/jpeg.py` decodes them).
"""

from __future__ import annotations

import json
import os

import numpy as np

from ursonet_torch import se3
from ursonet_torch.data.dataset import Dataset
from ursonet_torch.data.urso import encode_as_keypoints
from ursonet_torch.ops import encoders

SUBSETS = frozenset({'train', 'train_no_val', 'val', 'test', 'real',
                     'real_test', 'train_total'})
UNLABELED = frozenset({'test', 'real_test'})

# Euler-grid limits of the orientation histogram (degrees)
ORI_LIMITS = (np.array([-180.0, -90.0, -180.0]),
              np.array([180.0, 90.0, 180.0]))


class Camera:
    """SPEED camera intrinsics from the published focal length and pixel
    pitch."""
    fwx = fwy = 0.0176      # focal length [m]
    ppx = ppy = 5.86e-6     # pixel pitch [m/px]
    width, height = 1920, 1200
    fx, fy = fwx / ppx, fwy / ppy
    K = np.array([[fx, 0.0, width / 2.0],
                  [0.0, fy, height / 2.0],
                  [0.0, 0.0, 1.0]])


def quat_scalar_last(q_wxyz) -> np.ndarray:
    """Scalar-first `q_vbs2tango` -> scalar-last float32 on the north
    hemisphere (q_w >= 0); a submission undoes the reorder."""
    w, x, y, z = q_wxyz
    return np.sign(w) * np.array([x, y, z, w], np.float32)


def _image_subdir(subset: str) -> str:
    # the val split and its complement index into the train images
    return 'train' if subset in ('train_no_val', 'val') else subset


class Speed(Dataset):

    def load_dataset(self, dataset_dir, config, subset):
        if subset not in SUBSETS:
            raise ValueError(f"unknown SPEED subset {subset!r}; one of "
                             f"{sorted(SUBSETS)}")
        self.name = 'Speed'
        self.camera = Camera()
        if not os.path.exists(dataset_dir):
            print(f"Image directory '{dataset_dir}' not found.")
            return None
        with open(os.path.join(dataset_dir, subset + '.json')) as f:
            annotations = json.load(f)
        print(f'SPEED {subset}: indexing {len(annotations)} images')
        if subset in UNLABELED:
            self._index_unlabeled(dataset_dir, config, subset, annotations)
        else:
            self._index_labeled(dataset_dir, config, subset, annotations)
        self.num_images = len(self.image_info)
        self._image_ids = np.arange(self.num_images)

    def _index_labeled(self, dataset_dir, config, subset, annotations):
        files = [a['filename'] for a in annotations]
        t_array = np.array([a['r_Vo2To_vbs_true'] for a in annotations],
                           np.float32).reshape(-1, 3)
        q_array = np.stack([quat_scalar_last(a['q_vbs2tango'])
                            for a in annotations]).reshape(-1, 4)
        classify_ori = not config.REGRESS_ORI
        pmf = None
        if classify_ori:
            print('SPEED: precomputing orientation soft-assignment PMFs')
            pmf, self.ori_histogram_map, self.ori_output_mask = \
                encoders.encode_ori(q_array, config.ORI_BINS_PER_DIM,
                                    config.BETA, *ORI_LIMITS)
        K1, K2 = encode_as_keypoints(q_array, t_array)
        img_dir = os.path.join(dataset_dir, 'images', _image_subdir(subset))
        for i, q in enumerate(q_array):
            axis, theta = se3.quat2angleaxis(q)
            self.add_image(
                'SPEED', image_id=i, path=os.path.join(img_dir, files[i]),
                location=t_array[i], quaternion=q,
                pyr=np.asarray(se3.quat2euler(q)),
                angleaxis=np.asarray(axis) * theta,
                keypoints=[K1[i], K2[i]], location_map=[],
                ori_map=pmf[i] if classify_ori else [])

    def _index_unlabeled(self, dataset_dir, config, subset, annotations):
        # no ground truth: the decode still needs the bin->quaternion map;
        # the mask is all False, as the JAX package stores it here
        self.ori_histogram_map = encoders.build_ori_grid(
            config.ORI_BINS_PER_DIM).quat
        self.ori_output_mask = np.full(config.ORI_BINS_PER_DIM ** 3, False)
        img_dir = os.path.join(dataset_dir, 'images', subset)
        for i, ann in enumerate(annotations):
            self.add_image('SPEED', image_id=i,
                           path=os.path.join(img_dir, ann['filename']))
