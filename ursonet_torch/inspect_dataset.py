#!/usr/bin/env python3
"""Dataset and augmentation inspection, the port's twin of
`tools/inspect_dataset.py`: it writes the same figures, drawn by the
port's rasterizer (`ops/viz.py`) and PNG encoder instead of matplotlib
and PIL.

    python -m ursonet_torch.inspect_dataset --dataset_dir datasets/soyuz_easy \
        --type urso --subset train --out_dir /tmp/inspect [--n 6]

Per sampled frame (drawn by RandomState(--seed), as the JAX tool draws
them):
  * `sample_{i}.png`     the frame with its ground-truth axes
  * `augmented_{i}.png`  after a random camera rotation (the warp and the
                         consistent pose update, `ops/augment.rotate_cam`),
                         the axes redrawn
  * `sim2real_{i}.png`   after the host sim2real pipeline
                         (`ops/augment.sim2real_host`)
and with --classify_ori `ori_pmf_{i}.png`, the orientation PMF's slice
stack (`viz.visualize_weights`). Host code only: it needs no card.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('--dataset_dir', required=True)
    p.add_argument('--type', default='urso', choices=['urso', 'speed'])
    p.add_argument('--subset', default='train')
    p.add_argument('--out_dir', default='inspect_out')
    p.add_argument('--n', type=int, default=6)
    p.add_argument('--classify_ori', action='store_true',
                   help='load orientation PMF encodings too')
    p.add_argument('--seed', type=int, default=0)
    args = p.parse_args(argv)

    from ursonet_torch.config import Config
    from ursonet_torch.data.png import write_png
    from ursonet_torch.ops import augment as aug
    from ursonet_torch.ops import viz

    config = Config()
    config.REGRESS_ORI = not args.classify_ori
    config.ROT_AUG = True
    config.update()

    if args.type == 'urso':
        from ursonet_torch.data.urso import Urso
        ds = Urso()
        frame = 'unreal'
    else:
        from ursonet_torch.data.speed import Speed
        ds = Speed()
        frame = 'camera'
    ds.load_dataset(args.dataset_dir, config, args.subset)

    os.makedirs(args.out_dir, exist_ok=True)
    rng = np.random.RandomState(args.seed)
    ids = rng.choice(ds.image_ids, min(args.n, len(ds.image_ids)),
                     replace=False)
    for i in ids:
        image = ds.load_image(i)
        loc = np.asarray(ds.load_location(i), np.float64)
        q = np.asarray(ds.load_quaternion(i), np.float64)
        viz.save_axes_overlay(
            image, ds.camera.K, loc, q,
            path=os.path.join(args.out_dir, f'sample_{i}.png'), frame=frame)

        warped, loc2, q2 = aug.rotate_cam(image, loc, q, ds.camera.K, 20,
                                          rng)
        viz.save_axes_overlay(
            warped, ds.camera.K, np.ravel(loc2), np.ravel(q2),
            path=os.path.join(args.out_dir, f'augmented_{i}.png'),
            frame=frame)

        sim = aug.sim2real_host(image, rng)
        write_png(os.path.join(args.out_dir, f'sim2real_{i}.png'),
                  sim.astype(np.uint8))

        if args.classify_ori and ds.ori_histogram_map is not None:
            viz.visualize_weights(
                ds.load_orientation_encoded(i), config.ORI_BINS_PER_DIM,
                path=os.path.join(args.out_dir, f'ori_pmf_{i}.png'))
    print(f"wrote {len(ids)} sample sets to {args.out_dir}")


if __name__ == '__main__':
    main()
