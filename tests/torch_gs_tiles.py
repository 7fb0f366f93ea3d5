"""Gaussian-blend tiles for the tests of B17's per-warp cull: the CPU
tests of its plain mirror (`test_torch_gs_cull.py`), the GPU tests of the
kernel (`test_torch_kernels_gpu.py`) and `chip_ab.py`."""

import numpy as np
import torch

from nr3d_lib_tpu_torch.graphics import gaussian_splatting as GS


def near_floor_tiles(dev, n_t: int, k: int, tile: int, seed: int):
    """Tiles whose every slot puts one pixel of a random warp's box (the
    pixel nearest the slot's centre) within ±3 ulps of the opacity of the
    α floor, where B17's bound is tight: off a corner of the box along a
    rotated conic's smaller eigenvalue's axis, or off an edge on a pixel
    row or column with an isotropic conic. Colours in [0.2, 1], so a slot
    wrongly skipped moves a pixel by ≥ 0.2 / 255."""
    r = np.random.default_rng(seed)
    wp = GS._warp_pixels(tile).numpy()
    origin = np.stack([(np.arange(n_t) % 32) * tile,
                       (np.arange(n_t) // 32) * tile], -1).astype(np.float32)
    a = np.zeros((n_t, 11, k), np.float32)
    target = np.zeros((n_t, k), np.int64)
    for t in range(n_t):
        for j in range(k):
            pix = wp[r.integers(0, len(wp))]
            pix = pix[pix >= 0]
            cx, cy = pix % tile + 0.5, pix // tile + 0.5
            if r.uniform() < 0.5:           # off a corner
                sx, sy = r.choice([-1.0, 1.0], 2)
                tx = cx.max() if sx > 0 else cx.min()
                ty = cy.max() if sy > 0 else cy.min()
                phi = r.uniform(0.05, np.pi / 2 - 0.05)
                u = np.array([sx * np.cos(phi), sy * np.sin(phi)])
                lam = r.uniform(0.02, 2.0)
                ev = np.stack([u, [-u[1], u[0]]], 1)
                c = ev @ np.diag([lam, lam * r.uniform(1.0, 30.0)]) @ ev.T
            else:                           # off an edge, isotropic
                tx, ty = cx[r.integers(0, len(cx))], cy[r.integers(
                    0, len(cy))]
                side = r.integers(0, 4)
                u = np.array([[-1.0, 0], [1.0, 0], [0, -1.0], [0, 1.0]])[
                    side]
                tx = (cx.min(), cx.max(), tx, tx)[side]
                ty = (ty, ty, cy.min(), cy.max())[side]
                c = np.eye(2) * r.uniform(0.02, 2.0)
            d = r.uniform(0.3, 6.0)
            a[t, 0:2, j] = origin[t] + np.array([tx, ty]) + d * u
            a[t, 2:5, j] = c[0, 0], c[0, 1], c[1, 1]
            target[t, j] = int(ty - 0.5) * tile + int(tx - 0.5)
    a[:, 5] = 1.0
    a[:, 6:9] = r.uniform(0.2, 1.0, (n_t, 3, k))
    a[:, 9] = np.sort(r.uniform(1.0, 5.0, (n_t, k)), -1)
    a[:, 10] = 1.0
    at, og = torch.from_numpy(a), torch.from_numpy(origin)
    g = GS._alpha_parts(at, og, tile, 0.0)[2]                 # [T, P, K]
    g_t = torch.gather(g, 1, torch.from_numpy(target)[:, None, :])[:, 0]
    op = (np.float32(1.0 / 255.0) / g_t.numpy()).astype(np.float32)
    up = r.integers(-3, 4, op.shape)        # k ulps up or down, |k| ≤ 3
    for step in range(3):
        op = np.where(np.abs(up) > step, np.nextafter(
            op, np.where(up > 0, np.float32(np.inf), np.float32(0))), op)
    a[:, 5] = op
    return (torch.from_numpy(a).to(dev), torch.from_numpy(origin).to(dev),
            torch.from_numpy(target).to(dev))
