"""IP-Basic-style sparse depth completion (port of nr3d_lib_tpu/maths/
depth_completion.py, which runs it in numpy on the host).

Here it runs on tensors, on the device that holds the depth map. The
morphology is max and min filters over square windows, which are exact:
each is taken as a row pass then a column pass over the padded map (the
same extremum as over the k×k window, in fewer operations), so the result
is the numpy version's bit for bit on either device. The windows are the
numpy version's: `k // 2` padding on every side and offsets −k//2 …
k − 1 − k//2, so an even kernel (the fill's 3k + 1) reaches one further
up and left than down and right.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["depth_completion"]


def _window_extreme(d: torch.Tensor, k: int, pad_value: float,
                    op) -> torch.Tensor:
    """op (torch.maximum or torch.minimum) over each k×k window of d
    [H, W], padded by k // 2 with `pad_value`."""
    h, w = d.shape
    p = F.pad(d[None, None], (k // 2,) * 4, value=pad_value)[0, 0]
    rows = p[0:h]
    for i in range(1, k):
        rows = op(rows, p[i:i + h])
    out = rows[:, 0:w]
    for j in range(1, k):
        out = op(out, rows[:, j:j + w])
    return out


def _dilate(d: torch.Tensor, k: int) -> torch.Tensor:
    """Max filter over a k×k window, 0 outside the map."""
    return _window_extreme(d, k, 0.0, torch.maximum)


def _min_nonzero(d: torch.Tensor, k: int) -> torch.Tensor:
    """Min filter over a k×k window that skips zeros; 0 where a window
    holds none."""
    inf = torch.full_like(d, float("inf"))
    out = _window_extreme(torch.where(d == 0, inf, d), k, float("inf"),
                          torch.minimum)
    return torch.where(torch.isfinite(out), out, torch.zeros_like(out))


def depth_completion(depth, max_depth: float = 100.0, kernel: int = 5,
                     fill_remaining: bool = True) -> torch.Tensor:
    """Sparse (0 = missing) depth [H, W] → dense depth, float32, on the
    input's device (a numpy array goes to the CPU).

    IP-Basic: invert (so that a max filter prefers the closer surface),
    dilate, close small holes (dilate, then a min filter over non-zeros),
    fill the large holes with a (3k+1)-window dilation and the rest with
    the farthest plane, invert back, clip to [0, max_depth]."""
    d = torch.as_tensor(depth).to(torch.float32)
    zero = torch.zeros_like(d)
    inv = torch.where(d > 0.1, max_depth - d, zero)
    inv = _dilate(inv, kernel)
    closed = _min_nonzero(_dilate(inv, kernel), kernel)
    inv = torch.where(inv > 0, inv, closed)
    if fill_remaining:
        big = _dilate(inv, kernel * 3 + 1)
        inv = torch.where(inv > 0, inv, big)
        inv = torch.where(inv > 0, inv, torch.full_like(inv, 1e-3))
    out = torch.where(inv > 0, max_depth - inv, zero)
    return torch.clamp(out, 0.0, max_depth)
