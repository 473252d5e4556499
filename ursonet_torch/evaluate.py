"""Evaluation: the dataset loop, decode of raw head outputs and the ESA
score, the port of `ursonet_tpu/evaluate.py`.

`evaluate` runs a dataset through the serving engine in BATCH_SIZE
chunks (`_batched_forward`: the host decodes and molds the next chunk in
a `Prefetcher` thread, and each chunk's outputs are fetched after the
next chunk is dispatched), decodes, prints the mean errors and the ESA
score and writes `ori_err.csv`, `loc_err.csv` and `dists_err.csv` in
the bytes `pandas.DataFrame(x).to_csv(path)` writes, without pandas.
The errors are float32, as the JAX package computes them.
`evaluate_image` scores one frame, `detect_dataset` spot-checks random
frames (overlays with `out_dir`), `multimodal_orientations` fits a
quaternion mixture to each orientation PMF (`ops/gmm.py`).

The orientation bin map is the dataset's `ori_histogram_map` in the loop
(the port's `ops/encoders.build_ori_grid` quaternions for
config.ORI_BINS_PER_DIM, `ori_histogram_map(config)`, by default); a
location classification head needs the dataset's location bin map.
Keypoint heads decode by the Kabsch/SVD alignment of the predicted
keypoints with the model's (`se3t.kabsch_rotation`, batched in float64).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from ursonet_torch import se3t
from ursonet_torch.data.loader import keypoint_scale
from ursonet_torch.ops import decode as D
from ursonet_torch.ops.encoders import build_ori_grid


def ori_histogram_map(config) -> np.ndarray:
    """(bins³, 4) bin quaternions of config.ORI_BINS_PER_DIM."""
    return build_ori_grid(config.ORI_BINS_PER_DIM).quat


def decode_keypoints(loc, k1, k2, scale: float):
    """Poses from predicted keypoints [N,3] each: the rotation that
    aligns the model's keypoints P1 = [s·e3, s·e2, 0] (columns) with the
    predicted [k1, k2, loc], transposed, as a quaternion; the location is
    `loc`. Float64 tensors on the inputs' device."""
    loc, k1, k2 = (D._t(v).to(torch.float64) for v in (loc, k1, k2))
    P1 = torch.zeros(3, 3, dtype=torch.float64, device=loc.device)
    P1[2, 0] = P1[1, 1] = scale
    R = se3t.kabsch_rotation(P1, torch.stack([k1, k2, loc], dim=-1))
    return loc, se3t.SO32quat(R.transpose(-1, -2))


def decode_results(outputs, config, histogram_3d_map=None,
                   ori_map=None, power_iters: int = 50,
                   dataset_name: str = 'Urso'):
    """Batched decode of raw head outputs -> (loc_est [N,3], q_est [N,4])
    as float64 numpy arrays. Decodes on the outputs' device.
    `dataset_name` sets the keypoint scale (`loader.keypoint_scale`)."""
    if config.REGRESS_KEYPOINTS:
        loc_est, q_est = decode_keypoints(
            outputs['loc'], outputs['k1'], outputs['k2'],
            keypoint_scale(dataset_name))
    else:
        if config.REGRESS_LOC:
            loc_est = D._t(outputs['loc']).to(torch.float64)
        else:
            if histogram_3d_map is None:
                raise ValueError('a location classification head needs the '
                                 "dataset's histogram_3d_map")
            loc_est = D.decode_loc_pmf(outputs['loc'], histogram_3d_map)
        if config.REGRESS_ORI:
            q_est = D.decode_ori_regression(outputs['ori'],
                                            config.ORIENTATION_PARAM)
        else:
            q_est = D.decode_ori_pmf(
                outputs['ori'],
                ori_histogram_map(config) if ori_map is None else ori_map,
                power_iters)
    return (loc_est.cpu().numpy().astype(np.float64),
            q_est.cpu().numpy().astype(np.float64))


def esa_scores(loc_est, q_est, loc_gt, q_gt) -> dict:
    """Per-image ESA score, location error (m) and orientation error
    (deg), and their means, batched on the inputs' device."""
    esa = D.esa_score(loc_est, loc_gt, q_est, q_gt)
    loc_err = D.location_error(loc_est, loc_gt)
    ori_err = D.angular_error_deg(q_est, q_gt)
    out = {'esa': esa, 'loc_err': loc_err, 'ori_err_deg': ori_err}
    out = {k: v.cpu().numpy().astype(np.float64) for k, v in out.items()}
    out.update({f'mean_{k}': float(np.mean(v)) for k, v in list(out.items())})
    return out


# --------------------------------------------------------------------------
# the dataset loop


def _batched_forward(engine, dataset, image_ids) -> dict:
    """Mold and forward `image_ids` in BATCH_SIZE chunks (the tail chunk
    padded with its last id, its outputs trimmed); the raw head outputs
    stacked in id order as numpy arrays. The host loads and molds in a
    `Prefetcher` thread beside the device's forward, and each chunk's
    outputs are fetched after the next chunk is dispatched."""
    from ursonet_torch.data.loader import Prefetcher
    if not len(image_ids):
        raise ValueError("no images to evaluate (empty dataset subset)")
    bs = engine.config.BATCH_SIZE

    def molded_chunks():
        for i in range(0, len(image_ids), bs):
            chunk = list(image_ids[i:i + bs])
            chunk_ids = chunk + [chunk[-1]] * (bs - len(chunk))
            images = [dataset.load_image(j) for j in chunk_ids]
            molded, _, _ = engine.mold_inputs(images)
            yield len(chunk), molded

    def fetch(n, raw):
        return {k: v[:n].detach().cpu().numpy() for k, v in raw.items()}

    outs = []
    pending = None        # (n, device outputs), fetched one chunk late
    chunks = Prefetcher(molded_chunks(), depth=2)
    try:
        for n, molded in chunks:
            raw = engine.predict_molded(molded)
            if pending is not None:
                outs.append(fetch(*pending))
            pending = (n, raw)
    finally:
        chunks.close()
    outs.append(fetch(*pending))
    return {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}


def decode_dataset_results(outputs, config, dataset):
    """`decode_results` with the dataset's bin maps and keypoint scale."""
    return decode_results(
        outputs, config,
        histogram_3d_map=getattr(dataset, 'histogram_3D_map', None),
        ori_map=getattr(dataset, 'ori_histogram_map', None),
        dataset_name=getattr(dataset, 'name', 'Urso'))


def pose_errors(loc_est, loc_gt, q_est, q_gt) -> dict:
    """Per-image orientation error (deg), location error and ESA score
    as float32 numpy arrays, computed in float32 as the JAX package
    computes them (its inputs cast to float32)."""
    t = {k: torch.from_numpy(np.ascontiguousarray(v, np.float32))
         for k, v in (('loc_est', loc_est), ('loc_gt', loc_gt),
                      ('q_est', q_est), ('q_gt', q_gt))}
    return {
        'ori_err': D.angular_error_deg(t['q_est'], t['q_gt']).numpy(),
        'loc_err': D.location_error(t['loc_est'], t['loc_gt']).numpy(),
        'esa': D.esa_score(t['loc_est'], t['loc_gt'], t['q_est'],
                           t['q_gt']).numpy(),
    }


def write_csv(path: str, values) -> None:
    """A 1-D array as `pandas.DataFrame(values).to_csv(path)` writes it:
    the header ',0', then 'index,value' rows, each value in numpy's
    shortest round-trip form for its dtype, NaN as an empty field."""
    a = np.asarray(values).reshape(-1)
    text = a.astype(str)
    if a.dtype.kind == 'f':
        text = np.where(np.isnan(a), '', text)
    with open(path, 'w', newline='') as f:
        f.write(',0\n' + ''.join(f'{i},{v}\n' for i, v in enumerate(text)))


def encoding_errors(config, dataset, image_ids):
    """The quantization floor: the decoded ground-truth encodings against
    the raw ground truth, location (m) and orientation (deg) lists."""
    loc_errs, ori_errs = [], []
    for i in image_ids:
        loc_gt = np.asarray(dataset.load_location(i), np.float64)
        q_gt = np.asarray(dataset.load_quaternion(i), np.float64)
        if not config.REGRESS_LOC:
            enc = dataset.load_location_encoded(i)
            dec = np.asarray(enc, np.float64) @ np.asarray(
                dataset.histogram_3D_map, np.float64)
            loc_errs.append(float(np.linalg.norm(dec - loc_gt)))
        if not config.REGRESS_ORI:
            enc = np.asarray(dataset.load_orientation_encoded(i))
            q_dec = D.decode_ori_encoded(
                torch.from_numpy(np.ascontiguousarray(enc[None])),
                dataset.ori_histogram_map)[0].numpy()
            d = abs(float(np.dot(q_dec, q_gt)))
            ori_errs.append(2 * np.arccos(min(d, 1.0)) * 180 / np.pi)
    return loc_errs, ori_errs


def multimodal_orientations(outputs, config, dataset, nr_em_iterations=5):
    """Per-image quaternion mixtures fitted to the orientation PMFs
    (classification heads): a list of (means [N,4], variances [N],
    priors [N])."""
    from ursonet_torch.ops.gmm import fit_gmm_to_orientation
    if config.REGRESS_ORI:
        raise ValueError("--multimodal requires orientation "
                         "soft-classification")
    delta = config.BETA / config.ORI_BINS_PER_DIM
    var = delta ** 2 / 12
    pmfs = D.stable_softmax(torch.from_numpy(
        np.ascontiguousarray(outputs['ori']))).numpy()
    fits = []
    for pmf in pmfs:
        means, variances, priors, _ = fit_gmm_to_orientation(
            dataset.ori_histogram_map, pmf, nr_em_iterations, var)
        fits.append((means, variances, priors))
    return fits


def evaluate(engine, dataset, out_dir: str = '.', log_fn=print,
             multimodal: bool = False) -> dict:
    """Every image of `dataset` through the engine: returns the summary
    (mean location error, mean orientation error in degrees, ESA score,
    the encoding floors of classification heads and, with `multimodal`,
    the best-of-two-modes orientation error) and writes the per-image
    CSVs to `out_dir`."""
    cfg = engine.config
    ids = list(dataset.image_ids)
    outputs = _batched_forward(engine, dataset, ids)
    loc_est, q_est = decode_dataset_results(outputs, cfg, dataset)

    loc_gt = np.stack([dataset.load_location(i) for i in ids]).astype(
        np.float64)
    q_gt = np.stack([dataset.load_quaternion(i) for i in ids]).astype(
        np.float64)
    err = pose_errors(loc_est, loc_gt, q_est, q_gt)
    dists = loc_gt[:, 2]

    loc_enc_errs, ori_enc_errs = encoding_errors(cfg, dataset, ids)

    summary = {
        'mean_loc_err': float(np.mean(err['loc_err'])),
        'mean_ori_err_deg': float(np.mean(err['ori_err'])),
        'esa_score': float(np.mean(err['esa'])),
    }
    log_fn(f"Mean est. location error:  {summary['mean_loc_err']}")
    log_fn(f"Mean est. orientation error:  {summary['mean_ori_err_deg']}")
    log_fn(f"ESA score:  {summary['esa_score']}")
    if loc_enc_errs:
        summary['mean_loc_encoded_err'] = float(np.mean(loc_enc_errs))
        log_fn("Mean encoded location error:  "
               f"{summary['mean_loc_encoded_err']}")
    if ori_enc_errs:
        summary['mean_ori_encoded_err_deg'] = float(np.mean(ori_enc_errs))
        log_fn("Mean encoded orientation error:  "
               f"{summary['mean_ori_encoded_err_deg']}")

    if multimodal:
        fits = multimodal_orientations(outputs, cfg, dataset)
        oracle = []
        for (means, _, _), gt in zip(fits, q_gt):
            errs = 2 * np.arccos(np.clip(np.abs(means[:2] @ gt), 0, 1)) \
                * 180 / np.pi
            oracle.append(float(np.min(errs)))
        summary['multimodal_oracle_ori_err_deg'] = float(np.mean(oracle))
        log_fn("Multimodal best-of-2-modes orientation error:  "
               f"{summary['multimodal_oracle_ori_err_deg']}")

    os.makedirs(out_dir, exist_ok=True)
    write_csv(os.path.join(out_dir, "ori_err.csv"), err['ori_err'])
    write_csv(os.path.join(out_dir, "loc_err.csv"), err['loc_err'])
    write_csv(os.path.join(out_dir, "dists_err.csv"), dists)
    return summary


def evaluate_image(engine, dataset, image_id: int, log_fn=print) -> dict:
    """One image of `dataset`, run as a batch of BATCH_SIZE copies: its
    estimate and errors."""
    cfg = engine.config
    image = dataset.load_image(image_id)
    molded, _, _ = engine.mold_inputs([image] * cfg.BATCH_SIZE)
    raw = {k: v[:1].detach().cpu().numpy()
           for k, v in engine.predict_molded(molded).items()}
    loc_est, q_est = decode_dataset_results(raw, cfg, dataset)
    loc_gt = np.asarray(dataset.load_location(image_id), np.float64)
    q_gt = np.asarray(dataset.load_quaternion(image_id), np.float64)
    d = abs(float(np.dot(q_est[0], q_gt)))
    out = {
        'loc_est': loc_est[0], 'q_est': q_est[0],
        'loc_err': float(np.linalg.norm(loc_est[0] - loc_gt)),
        'ori_err_deg': 2 * np.arccos(min(d, 1.0)) * 180 / np.pi,
    }
    log_fn(f"Loc Error: {out['loc_err']}  Ori Error: {out['ori_err_deg']}")
    return out


def detect_dataset(engine, dataset, n_images: int = 10,
                   seed: Optional[int] = 7, out_dir: Optional[str] = None,
                   log_fn=print, multimodal: bool = False):
    """Spot-check `n_images` random images (drawn by RandomState(seed)):
    each one's estimate and errors printed and returned, with `out_dir`
    an axes overlay each (`ops/viz.py`), with `multimodal` each one's
    mixture modes."""
    rng = np.random.RandomState(seed)
    ids = rng.choice(dataset.image_ids,
                     min(n_images, len(dataset.image_ids)), replace=False)
    outputs = _batched_forward(engine, dataset, list(ids))
    loc_est, q_est = decode_dataset_results(outputs, engine.config, dataset)
    fits = multimodal_orientations(outputs, engine.config, dataset) \
        if multimodal else None
    results = []
    for n, i in enumerate(ids):
        loc_gt = np.asarray(dataset.load_location(i), np.float64)
        q_gt = np.asarray(dataset.load_quaternion(i), np.float64)
        d = abs(float(np.dot(q_est[n], q_gt)))
        r = {'image_id': int(i), 'loc_est': loc_est[n], 'q_est': q_est[n],
             'loc_err': float(np.linalg.norm(loc_est[n] - loc_gt)),
             'ori_err_deg': 2 * np.arccos(min(d, 1.0)) * 180 / np.pi}
        log_fn(f"Image {i}: loc_err={r['loc_err']:.3f} "
               f"ori_err={r['ori_err_deg']:.2f} deg")
        if fits is not None:
            means, variances, priors = fits[n]
            r['modes'] = [
                {'q': means[m].tolist(), 'prior': float(priors[m]),
                 'var': float(variances[m])}
                for m in range(len(means))]
            for m, mode in enumerate(r['modes']):
                log_fn(f"  mode {m}: prior={mode['prior']:.3f} "
                       f"var={mode['var']:.5f} "
                       f"q={np.round(mode['q'], 4).tolist()}")
        results.append(r)
        if out_dir:
            from ursonet_torch.ops import viz
            os.makedirs(out_dir, exist_ok=True)
            viz.save_axes_overlay(
                dataset.load_image(i), dataset.camera.K,
                loc_gt, q_gt, loc_est[n], q_est[n],
                os.path.join(out_dir, f"overlay_{i}.png"))
    return results
