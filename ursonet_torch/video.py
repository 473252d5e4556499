"""Video inference, the counterpart of `ursonet_tpu/video.py`
(`detect_video`, `_overlay_axes`): read a clip, estimate each frame's
pose, draw the estimated body axes over it and write the annotated clip.

Frames are served in batches of BATCH_SIZE (the last batch padded with
copies of its last frame), gray frames stacked to RGB, the poses decoded
with the dataset's bin maps, and the axes drawn as cv2 draws them in the
JAX package: x red (255,0,0), y green (0,255,0), z blue (0,0,255) in RGB,
2 px, solid, between the projected origin and each axis end, the
endpoints clamped to cv2's coordinate range. The port draws them with its
own rasterizer (`data/synthetic.draw_segment`, through `ops/viz.py`),
not cv2's pixels.

Stated deviation: the clip is read and written as Motion-JPEG in AVI
(`data/avi.py`), the container and codec the port implements, and the
default output is `<base>_annotated.avi`; the JAX package writes mp4v
`.mp4` through cv2 and reads whatever cv2 reads.
"""

from __future__ import annotations

import os
import time

import numpy as np

from ursonet_torch.data.avi import AviReader, AviWriter
from ursonet_torch.evaluate import decode_dataset_results
from ursonet_torch.ops import viz

AXIS_COLORS = ((255, 0, 0), (0, 255, 0), (0, 0, 255))
TIMED = ('decode', 'serve', 'draw', 'encode')


def _pt(v):
    """An endpoint as cv2 takes it in the JAX package: NaN -> 0, +-inf ->
    +-1e6, clipped to [-32768, 32767], truncated to int."""
    v = np.nan_to_num(np.asarray(v, np.float64), nan=0.0, posinf=1e6,
                      neginf=-1e6)
    return tuple(int(x) for x in np.clip(v, -32768, 32767))


def overlay_endpoints(K, loc, q, frame_convention='unreal',
                      scale: float = 1.0):
    """(origin, [x end, y end, z end]) in integer pixels, as
    `_overlay_axes` hands them to cv2.line."""
    origin, ends = viz.axes_endpoints(q, loc, scale)
    o2 = viz.project_points(K, origin[None], frame_convention)[0]
    e2 = viz.project_points(K, ends, frame_convention)
    return _pt(o2), [_pt(e) for e in e2]


def overlay_axes(frame, K, loc, q, frame_convention='unreal',
                 scale: float = 1.0) -> np.ndarray:
    """The frame ([H, W, 3] uint8 RGB) with the estimated body axes."""
    out = np.array(frame, dtype=np.uint8, copy=True)
    o, ends = overlay_endpoints(K, loc, q, frame_convention, scale)
    for e, color in zip(ends, AXIS_COLORS):
        viz.draw_line(out, o, e, color)
    return out


def detect_video(engine, dataset, video_path: str, out_path: str = None,
                 max_frames: int = None, log_fn=print,
                 timings: dict = None) -> str:
    """Annotate a video with per-frame pose estimates; returns the
    output path. `timings`, a dict, gets the seconds spent in each of
    TIMED (decode, serve: mold + forward + pose decode, draw, encode) and
    the frame count under 'frames'."""
    cfg = engine.config
    if engine.model is None:
        engine.initialize()
    if out_path is None:
        base, _ = os.path.splitext(video_path)
        out_path = base + '_annotated.avi'
    t = {k: 0.0 for k in TIMED}

    frame_conv = 'unreal' if dataset.name == 'Urso' else 'camera'
    reader = AviReader(video_path)
    writer = AviWriter(out_path, reader.fps)
    bs = cfg.BATCH_SIZE
    buf = []
    n_done = 0

    def flush(buf):
        nonlocal n_done
        if not buf:
            return
        t0 = time.perf_counter()
        batch = buf + [buf[-1]] * (bs - len(buf))
        molded, _, _ = engine.mold_inputs(batch)
        raw = {k: v.cpu().numpy()[:len(buf)]
               for k, v in engine.predict_molded(molded).items()}
        locs, qs = decode_dataset_results(raw, cfg, dataset)
        t['serve'] += time.perf_counter() - t0
        for i, frame in enumerate(buf):
            t0 = time.perf_counter()
            drawn = overlay_axes(frame, dataset.camera.K, locs[i], qs[i],
                                 frame_conv)
            t1 = time.perf_counter()
            writer.append(drawn)
            t['draw'] += t1 - t0
            t['encode'] += time.perf_counter() - t1
            n_done += 1
        buf.clear()

    try:
        frames = iter(reader)
        while True:
            t0 = time.perf_counter()
            frame = next(frames, None)
            t['decode'] += time.perf_counter() - t0
            if frame is None:
                break
            if frame.ndim == 2:
                frame = np.stack([frame] * 3, axis=-1)
            buf.append(frame[..., :3])
            if len(buf) == bs:
                flush(buf)
            # the JAX package's check, which counts the buffered frames
            # after a flush emptied it
            if max_frames and n_done + len(buf) >= max_frames:
                break
        flush(buf)
    finally:
        writer.close()
        reader.close()
    if timings is not None:
        timings.update(t, frames=n_done)
    log_fn(f"Annotated video written to {out_path} ({n_done} frames)")
    return out_path
