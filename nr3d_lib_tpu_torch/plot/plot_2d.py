"""2D image annotation helpers: boxes, masks, patches, distinct colors
(port of nr3d_lib_tpu/plot/plot_2d.py). numpy alone, with one shared
window-clipping helper; `draw_2dbox_labeled` draws its border and label
with cv2 only when cv2 imports, as in JAX, and its border with numpy
otherwise.
"""

from __future__ import annotations

import colorsys
from typing import Optional, Sequence, Tuple

import numpy as np

__all__ = ["get_n_ind_colors", "choose_contrast_color", "draw_2dbox_labeled",
           "draw_bool_mask", "draw_int_mask", "draw_patch"]


def get_n_ind_colors(n: int, s: float = 0.65, v: float = 0.95
                     ) -> np.ndarray:
    """n visually-distinct uint8 RGB colors via golden-ratio hue
    stepping."""
    phi = 0.6180339887498949
    cols = [colorsys.hsv_to_rgb((i * phi) % 1.0, s, v) for i in range(n)]
    return (np.asarray(cols) * 255).astype(np.uint8)


def choose_contrast_color(color: Sequence[int]) -> Tuple[int, int, int]:
    """Black or white, whichever contrasts the given RGB."""
    r, g, b = [float(c) for c in color[:3]]
    luma = 0.299 * r + 0.587 * g + 0.114 * b
    return (0, 0, 0) if luma > 127 else (255, 255, 255)


def _window(im_shape, patch_shape, h0: int, w0: int):
    """Clip a patch placement against the image: returns
    (im_slice, patch_slice) or None when fully outside."""
    h, w = im_shape[:2]
    hm, wm = patch_shape[:2]
    h1, w1 = min(h0 + hm, h), min(w0 + wm, w)
    ph0, pw0 = max(0, -h0), max(0, -w0)
    ih0, iw0 = max(0, h0), max(0, w0)
    if ih0 >= h1 or iw0 >= w1:
        return None
    return ((slice(ih0, h1), slice(iw0, w1)),
            (slice(ph0, ph0 + h1 - ih0), slice(pw0, pw0 + w1 - iw0)))


def draw_bool_mask(im: np.ndarray, mask: np.ndarray,
                   color=(255, 0, 0), alpha: float = 0.5,
                   h0: int = 0, w0: int = 0) -> np.ndarray:
    """Alpha-blend a boolean mask patch onto a uint8 image. The patch may
    extend past any image edge."""
    win = _window(im.shape, mask.shape, h0, w0)
    if win is None:
        return im
    iw, pw = win
    im = im.copy()
    sel = im[iw].astype(np.float32)
    blended = sel * (1 - alpha) + alpha * np.asarray(color, np.float32)
    im[iw] = np.where(mask[pw][..., None], blended, sel).astype(np.uint8)
    return im


def draw_int_mask(im: np.ndarray, mask: np.ndarray,
                  cmap: Optional[np.ndarray] = None, alpha: float = 1.0,
                  h0: int = 0, w0: int = 0) -> np.ndarray:
    """Blend an integer id-mask colored through cmap [N,3]; cmap defaults
    to get_n_ind_colors(max+1)."""
    if cmap is None:
        cmap = get_n_ind_colors(int(mask.max()) + 1)
    win = _window(im.shape, mask.shape, h0, w0)
    if win is None:
        return im
    iw, pw = win
    im = im.copy()
    colored = np.asarray(cmap)[mask[pw]].astype(np.float32)
    im[iw] = (im[iw] * (1 - alpha) + alpha * colored).astype(np.uint8)
    return im


def draw_patch(im: np.ndarray, patch: np.ndarray, alpha: float = 1.0,
               h0: int = 0, w0: int = 0) -> np.ndarray:
    """Blend an RGB patch onto the image."""
    win = _window(im.shape, patch.shape, h0, w0)
    if win is None:
        return im
    iw, pw = win
    im = im.copy()
    im[iw] = (im[iw] * (1 - alpha)
              + alpha * patch[pw].astype(np.float32)).astype(np.uint8)
    return im


def draw_2dbox_labeled(im: np.ndarray, center_x: float, center_y: float,
                       width: float, height: float, color=(255, 0, 0),
                       fill_alpha: float = 0.1, linewidth: int = 2,
                       label: Optional[str] = None,
                       label2: Optional[str] = None,
                       fontscale: float = 0.5) -> np.ndarray:
    """Box with translucent fill, border, and an optional 1-2 line label
    chip; without cv2, the border alone, drawn with numpy."""
    im = im.copy()
    x0 = int(center_x - width / 2)
    y0 = int(center_y - height / 2)
    x1 = int(center_x + width / 2)
    y1 = int(center_y + height / 2)
    # translucent fill via the mask blender
    if fill_alpha > 0 and y1 > y0 and x1 > x0:
        im = draw_bool_mask(im, np.ones((y1 - y0, x1 - x0), bool), color,
                            fill_alpha, y0, x0)
    try:
        import cv2
    except Exception:
        # numpy border
        for (ys, xs) in (((y0, y0 + linewidth), (x0, x1)),
                         ((y1 - linewidth, y1), (x0, x1)),
                         ((y0, y1), (x0, x0 + linewidth)),
                         ((y0, y1), (x1 - linewidth, x1))):
            win = _window(im.shape, (ys[1] - ys[0], xs[1] - xs[0]),
                          ys[0], xs[0])
            if win is not None:
                im[win[0]] = color
        return im
    cv2.rectangle(im, (x0, y0), (x1, y1), tuple(int(c) for c in color),
                  linewidth)
    if label is not None:
        text_color = choose_contrast_color(color)
        lines = [label] + ([label2] if label2 else [])
        sizes = [cv2.getTextSize(t, cv2.FONT_HERSHEY_SIMPLEX, fontscale, 1)[0]
                 for t in lines]
        chip_w = max(s[0] for s in sizes) + 6
        chip_h = sum(s[1] for s in sizes) + 6 * len(lines)
        cv2.rectangle(im, (x0, y0), (x0 + chip_w, y0 + chip_h),
                      tuple(int(c) for c in color), -1)
        y = y0
        for t, s in zip(lines, sizes):
            y += s[1] + 4
            cv2.putText(im, t, (x0 + 3, y), cv2.FONT_HERSHEY_SIMPLEX,
                        fontscale, text_color, 1, cv2.LINE_AA)
    return im
