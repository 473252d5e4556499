"""The inspection plots of the port (`ops/viz.py`: `polar_plot`,
`visualize_weights`) and its twin of `tools/inspect_dataset.py`
(`python -m ursonet_torch.inspect_dataset`), against the JAX package's
figures on the CPU. The port draws the JAX figure's content, not
matplotlib's pixels: the checks are the rays' angles (the JAX package's
`se3.quat2euler`, exact in float64), the grid of PMF tiles and each
tile's brightest cell against the cube the JAX function slices."""

import os

import numpy as np
import pytest

from ursonet_tpu import se3 as jse3
from ursonet_tpu.ops import viz as jviz
from ursonet_torch import inspect_dataset
from ursonet_torch.data.png import decode_png
from ursonet_torch.data.synthetic import make_urso_dataset
from ursonet_torch.ops import viz
from torch_parity import unit_quats


def test_polar_rays_are_jaxs_euler_angles(tmp_path):
    rng = np.random.RandomState(0)
    q_gt, q_est = unit_quats(rng, 2).astype(np.float64)
    rays = viz.polar_rays(q_gt, q_est)
    gt = np.asarray(jse3.quat2euler(q_gt))
    est = np.asarray(jse3.quat2euler(q_est))
    assert [r[0] for r in rays] == ['pitch gt', 'pitch est', 'yaw gt',
                                    'yaw est', 'roll gt', 'roll est']
    for i in range(3):
        assert rays[2 * i][1] == np.deg2rad(float(gt[i]))
        assert rays[2 * i + 1][1] == np.deg2rad(float(est[i]))
        assert rays[2 * i][2:4] == (1.0, False)
        assert rays[2 * i + 1][2:4] == (0.8, True)
    path = viz.polar_plot(q_gt, q_est, str(tmp_path / 'polar.png'))
    with open(path, 'rb') as f:
        img = decode_png(f.read())
    assert img.shape == (viz.POLAR_PX, viz.POLAR_PX, 3)
    # each ground-truth ray's colour sits halfway along it
    for _, angle, radius, dashed, color in rays[::2]:
        x, y = np.rint(viz.polar_point(angle, radius / 2)).astype(int)
        patch = img[y - 1:y + 2, x - 1:x + 2].reshape(-1, 3)
        assert (patch == color).all(axis=1).any()
    jviz.polar_plot(q_gt, q_est, str(tmp_path / 'jax.png'))   # still draws


@pytest.mark.parametrize('bins,size,max_slices', [(6, 216, 16),
                                                  (24, 13000, 16),
                                                  (5, 125, 4)])
def test_weight_tiles_are_the_cubes_slices(tmp_path, bins, size,
                                           max_slices):
    """The grid, and each tile's brightest cell where the JAX figure's
    slice has its max (a short PMF zero-padded, as the JAX function)."""
    rng = np.random.RandomState(bins)
    pmf = rng.rand(size) ** 4
    full = np.zeros(bins ** 3)
    full[:min(size, bins ** 3)] = pmf[:bins ** 3]
    cube = full.reshape(bins, bins, bins)
    n = min(bins, max_slices)
    cols = int(np.ceil(np.sqrt(n)))
    rows, got_cols, step, tiles = viz.weight_tiles(pmf, bins, max_slices)
    assert (rows, got_cols, step) == (int(np.ceil(n / cols)), cols,
                                      max(1, bins // n))
    assert len(tiles) == n
    img = viz.draw_weights(pmf, bins, max_slices)
    side = bins * viz.TILE_CELL_PX
    pitch = side + viz.TILE_GAP_PX
    for k, tile in enumerate(tiles):
        np.testing.assert_array_equal(tile, cube[:, k * step, :] / cube.max())
        y0 = viz.TILE_GAP_PX + (k // cols) * pitch
        x0 = viz.TILE_GAP_PX + (k % cols) * pitch
        cells = img[y0:y0 + side:viz.TILE_CELL_PX,
                    x0:x0 + side:viz.TILE_CELL_PX]
        # viridis brightens monotonically: the largest green channel
        want = np.unravel_index(np.argmax(cube[:, k * step, :]),
                                (bins, bins))
        assert cells[..., 1][want] == cells[..., 1].max()
    path = viz.visualize_weights(pmf, bins, str(tmp_path / 'pmf.png'),
                                 max_slices)
    with open(path, 'rb') as f:
        assert decode_png(f.read()).shape == img.shape


def test_inspect_dataset_writes_the_jax_tools_files(tmp_path):
    d = str(tmp_path / 'ds')
    make_urso_dataset(d, subsets=('train',), n_per_subset=4, width=128,
                      height=96, seed=3)
    out = str(tmp_path / 'out')
    inspect_dataset.main(['--dataset_dir', d, '--out_dir', out, '--n', '2',
                          '--classify_ori'])
    ids = np.random.RandomState(0).choice(4, 2, replace=False)
    want = {f'{kind}_{i}.png' for i in ids
            for kind in ('sample', 'augmented', 'sim2real', 'ori_pmf')}
    assert set(os.listdir(out)) == want
    for name in want:
        with open(os.path.join(out, name), 'rb') as f:
            img = decode_png(f.read())
        assert img.ndim == 3 and img.shape[2] == 3
