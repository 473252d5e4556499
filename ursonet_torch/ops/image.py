"""Resize geometry, the part of `ursonet_tpu/ops/image.py::resize_image`
that the on-device preprocess needs: the scale and the window of the
un-padded content for a given source size and resize mode. No pixels are
touched here, so no image library is needed.
"""

from __future__ import annotations


def _pick_scale(h, w, min_dim, max_dim, min_scale, clamp_max):
    """Bring the small side up to `min_dim`, floor at `min_scale`, then cap
    so the long side does not exceed `max_dim` (the cap wins)."""
    scale = min_dim / min(h, w) if min_dim else 1
    if min_scale:
        scale = max(scale, min_scale)
    if clamp_max and max_dim and round(max(h, w) * scale) > max_dim:
        scale = max_dim / max(h, w)
    return scale


def _centered_window(h, w, out_h, out_w):
    top, left = (out_h - h) // 2, (out_w - w) // 2
    return (top, left, top + h, left + w)


def resize_geometry(h, w, min_dim=None, max_dim=None, min_scale=None,
                    mode="square"):
    """(out_shape, window, scale) that `resize_image` gives an h×w image.

    out_shape is (out_h, out_w); window = (y1, x1, y2, x2) frames the
    resized content inside the output. For 'crop' the window is the
    whole min_dim² crop (its offset is random and does not move the
    intrinsics of the crop's own pixel grid).
    """
    if mode == "none":
        return (h, w), (0, 0, h, w), 1
    scale = _pick_scale(h, w, min_dim, max_dim, min_scale,
                        clamp_max=(mode != "crop"))
    if scale != 1:
        h, w = round(h * scale), round(w * scale)
    if mode == "square":
        out = (max_dim, max_dim)
    elif mode == "pad64":
        if min_dim % 64:
            raise ValueError("pad64 requires min_dim % 64 == 0")
        out = (-(-h // 64) * 64, -(-w // 64) * 64)
    elif mode == "crop":
        return (min_dim, min_dim), (0, 0, min_dim, min_dim), scale
    else:
        raise ValueError(f"unknown resize mode: {mode!r}")
    return out, _centered_window(h, w, *out), scale
