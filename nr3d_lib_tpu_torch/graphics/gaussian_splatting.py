"""3D Gaussian splatting renderer (+ relightable render-equation head).

Port of nr3d_lib_tpu/graphics/gaussian_splatting.py, with the same names
and the same two paths:

  * `rasterize_gaussians` — the dense depth-sorted pixel×gaussian
    contraction in pixel chunks, O(P·N): the parity oracle.
  * `rasterize_gaussians_tiled` — the tile-binned pipeline: each gaussian
    emits up to `tiles_per_gaussian` (tile, depth) pairs (`_expand_pairs`),
    one stable sort orders them by (tile, depth) (`_sort_pairs`), a
    `searchsorted` + gather builds the [tiles, capacity] id table
    (`_tile_table`), the tiles' slots gather their attributes into a
    [T, 11, K] layout (`_gather_attrs`), and every tile blends its ≤ K
    gaussians front to back (`gs_blend`).

The blend has one route, `gs_blend`: on a CUDA tensor the `gs_blend`
kernel of `csrc/gaussian_blend.cu` (B17) and, in backward, `gs_blend_bwd`
(B18); on a CPU tensor their plain versions (`gs_blend_plain`,
`gs_blend_bwd_plain`). B18's per-slot gradients
[T, 11, K] reach the gaussians through the autograd of the attribute
gather (an index_add) and of the plain projection.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch.autograd.function import once_differentiable

from nr3d_lib_tpu_torch.maths.transforms import quaternion_to_matrix
from nr3d_lib_tpu_torch.models.embedders import sh_encode
from nr3d_lib_tpu_torch.ops import _build

__all__ = ["project_gaussians", "rasterize_gaussians",
           "rasterize_gaussians_tiled", "mark_visible",
           "render_equation", "render_equation_r3dg", "eval_sh_colors",
           "gs_blend", "gs_blend_plain", "gs_blend_bwd_plain"]

Tensor = torch.Tensor

# attrs-row indices of the per-tile [T, N_ATTR, K] layout
_A_MUX, _A_MUY, _A_IC00, _A_IC01, _A_IC11, _A_OP, \
    _A_CR, _A_CG, _A_CB, _A_DEP, _A_LIVE = range(11)
N_ATTR = 11
MAX_TILE = 32          # one thread per pixel, ≤ 1024 threads per block


def _cov3d(scales: Tensor, quats: Tensor) -> Tensor:
    """Σ = R S Sᵀ Rᵀ."""
    r = quaternion_to_matrix(quats)
    s = r * scales[..., None, :]
    return s @ s.transpose(-1, -2)


def project_gaussians(means: Tensor, scales: Tensor, quats: Tensor,
                      w2c: Tensor, intr: Tensor) -> Dict[str, Tensor]:
    """World gaussians → screen-space (EWA splatting).

    means [N,3]; scales [N,3]; quats [N,4]; w2c [4,4]; intr [3,3].
    Returns mean2d [N,2], cov2d [N,2,2], depth [N], in_front mask.
    """
    r = w2c[:3, :3]
    t = w2c[:3, 3]
    cam = means @ r.T + t
    z = cam[:, 2]
    fx, fy = intr[0, 0], intr[1, 1]
    mean2d = torch.stack([cam[:, 0] / z * fx + intr[0, 2],
                          cam[:, 1] / z * fy + intr[1, 2]], -1)
    # Jacobian of the perspective projection
    zero = torch.zeros_like(z)
    j = torch.stack([
        torch.stack([fx / z, zero, -fx * cam[:, 0] / (z * z)], -1),
        torch.stack([zero, fy / z, -fy * cam[:, 1] / (z * z)], -1)], -2)
    cov3 = _cov3d(scales, quats)
    cov_cam = torch.einsum("ij,njk,lk->nil", r, cov3, r)
    cov2d = torch.einsum("nij,njk,nlk->nil", j, cov_cam, j)
    # low-pass (anti-alias): +0.3 px
    cov2d = cov2d + 0.3 * torch.eye(2, dtype=cov2d.dtype, device=cov2d.device)
    return {"mean2d": mean2d, "cov2d": cov2d, "depth": z,
            "in_front": z > 0.01}


def mark_visible(means: Tensor, w2c: Tensor, intr: Tensor,
                 hw: Tuple[int, int], margin: float = 0.1) -> Tensor:
    """Frustum visibility."""
    h, w = hw
    proj = project_gaussians(means, torch.ones_like(means) * 1e-6,
                             torch.cat([torch.ones_like(means[:, :1]),
                                        torch.zeros_like(means)], -1),
                             w2c, intr)
    m = proj["mean2d"]
    pad_w, pad_h = margin * w, margin * h
    return (proj["in_front"] & (m[:, 0] > -pad_w) & (m[:, 0] < w + pad_w)
            & (m[:, 1] > -pad_h) & (m[:, 1] < h + pad_h))


def _screen_radius(cov2d: Tensor) -> Tensor:
    """3σ extent from the 2D covariance's largest eigenvalue."""
    mid = 0.5 * (cov2d[:, 0, 0] + cov2d[:, 1, 1])
    det = cov2d[:, 0, 0] * cov2d[:, 1, 1] - cov2d[:, 0, 1] * cov2d[:, 1, 0]
    lam = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.0))
    return 3.0 * torch.sqrt(torch.clamp(lam, min=0.0))


def _inv_cov2d(cov2d: Tensor) -> Tensor:
    det = cov2d[:, 0, 0] * cov2d[:, 1, 1] - cov2d[:, 0, 1] * cov2d[:, 1, 0]
    det = torch.clamp(det, min=1e-9)
    return torch.stack([
        torch.stack([cov2d[:, 1, 1], -cov2d[:, 0, 1]], -1),
        torch.stack([-cov2d[:, 1, 0], cov2d[:, 0, 0]], -1)],
        -2) / det[:, None, None]


def _bg(bg_color, like: Tensor) -> Tensor:
    return torch.as_tensor(bg_color, dtype=like.dtype, device=like.device)


def rasterize_gaussians(means: Tensor, scales: Tensor, quats: Tensor,
                        opacities: Tensor, colors: Tensor,
                        w2c: Tensor, intr: Tensor, hw: Tuple[int, int],
                        bg_color=(0.0, 0.0, 0.0),
                        pixel_chunk: int = 4096,
                        alpha_floor: float = 1.0 / 255.0
                        ) -> Dict[str, Tensor]:
    """Render gaussians → {rgb [H,W,3], alpha [H,W], depth [H,W]}.

    Depth-sorted global compositing α_i(p)·Π_{j<i}(1-α_j(p)), evaluated
    densely per pixel chunk.
    """
    h, w = hw
    proj = project_gaussians(means, scales, quats, w2c, intr)
    inf = torch.full_like(proj["depth"], float("inf"))
    order = torch.argsort(torch.where(proj["in_front"], proj["depth"], inf),
                          stable=True)
    mean2d = proj["mean2d"][order]
    inv = _inv_cov2d(proj["cov2d"][order])
    depth = proj["depth"][order]
    valid = proj["in_front"][order]
    op = opacities.reshape(-1)[order]
    col = colors[order]

    dt, dev = means.dtype, means.device
    ys, xs = torch.meshgrid(torch.arange(h, dtype=dt, device=dev) + 0.5,
                            torch.arange(w, dtype=dt, device=dev) + 0.5,
                            indexing="ij")
    pix = torch.stack([xs, ys], -1).reshape(-1, 2)
    bg = _bg(bg_color, means)

    def render_chunk(p):
        d = p[:, None, :] - mean2d[None]                       # [P,N,2]
        md = (d[..., 0] ** 2 * inv[None, :, 0, 0]
              + d[..., 1] ** 2 * inv[None, :, 1, 1]
              + 2 * d[..., 0] * d[..., 1] * inv[None, :, 0, 1])
        alpha = torch.clamp(op[None] * torch.exp(-0.5 * md), 0.0, 0.999)
        alpha = torch.where(valid[None] & (alpha > alpha_floor), alpha,
                            torch.zeros_like(alpha))
        trans = torch.cumprod(1.0 - alpha + 1e-10, dim=-1)
        trans = torch.cat([torch.ones_like(trans[:, :1]), trans[:, :-1]], -1)
        vw = alpha * trans                                     # [P,N]
        rgb = vw @ col
        acc = torch.sum(vw, -1)
        dep = vw @ depth / torch.clamp(acc, min=1e-10)
        rgb = rgb + (1.0 - acc)[:, None] * bg
        return rgb, acc, dep

    outs = [render_chunk(pix[s:s + pixel_chunk])
            for s in range(0, pix.shape[0], pixel_chunk)]
    return {"rgb": torch.cat([o[0] for o in outs]).reshape(h, w, 3),
            "alpha": torch.cat([o[1] for o in outs]).reshape(h, w),
            "depth": torch.cat([o[2] for o in outs]).reshape(h, w)}


def eval_sh_colors(shs: Tensor, dirs: Tensor) -> Tensor:
    """View-dependent colour from per-gaussian SH coefficients.

    shs [N, K, 3] with K ∈ {1, 4, 9, 16}; dirs [N, 3] (camera→gaussian,
    need not be normalized). Returns rgb [N, 3], clamped at 0."""
    degree = int(round(math.sqrt(shs.shape[1])))
    if degree * degree != shs.shape[1]:
        raise ValueError("K must be a square (1/4/9/16)")
    d = dirs / torch.clamp(torch.linalg.norm(dirs, dim=-1, keepdim=True),
                           min=1e-8)
    basis = sh_encode(d, degree)                                  # [N, K]
    return torch.clamp(torch.einsum("nk,nkc->nc", basis, shs) + 0.5, min=0.0)


# ------------------------------------------------ the tiled pipeline stages
def _expand_pairs(mean2d: Tensor, radius: Tensor, on_screen: Tensor,
                  depth: Tensor, tile: int, th: int, tw: int, win: int
                  ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Each gaussian → win×win candidate tiles anchored at its bbox corner.
    Returns pair_tile [M] (n_tiles where the pair is dead), pair_gid [M],
    pair_depth [M] (M = N·win²) and n_dropped_window (the tiles that the
    bbox covers beyond the window)."""
    n = mean2d.shape[0]
    n_tiles = th * tw
    dev = mean2d.device

    def tidx(v):
        return torch.floor(v / tile).to(torch.int32)

    t0x = tidx(mean2d[:, 0] - radius)
    t0y = tidx(mean2d[:, 1] - radius)
    t1x = tidx(mean2d[:, 0] + radius)
    t1y = tidx(mean2d[:, 1] + radius)
    dx = torch.arange(win, dtype=torch.int32, device=dev)
    tx = (t0x[:, None, None] + dx[None, None, :]).expand(n, win, win)
    ty = (t0y[:, None, None] + dx[None, :, None]).expand(n, win, win)
    pair_ok = (on_screen[:, None, None]
               & (tx >= 0) & (tx < tw) & (ty >= 0) & (ty < th)
               & (tx <= t1x[:, None, None]) & (ty <= t1y[:, None, None]))
    covered = ((torch.clamp(t1x, 0, tw - 1) - torch.clamp(t0x, min=0) + 1)
               * (torch.clamp(t1y, 0, th - 1) - torch.clamp(t0y, min=0) + 1)
               - win * win)
    n_dropped_window = torch.sum(torch.clamp(covered, min=0).to(torch.int64)
                                 * on_screen)
    dead = torch.full_like(tx, n_tiles)
    pair_tile = torch.where(pair_ok, ty * tw + tx, dead).reshape(-1)
    pair_gid = torch.arange(n, dtype=torch.int32, device=dev)[:, None, None] \
        .expand(n, win, win).reshape(-1)
    pair_depth = depth[:, None, None].expand(n, win, win).reshape(-1)
    return pair_tile, pair_gid, pair_depth, n_dropped_window


def _sort_pairs(pair_tile: Tensor, pair_depth: Tensor, pair_gid: Tensor,
                n_tiles: int, packed: Optional[bool] = None
                ) -> Tuple[Tensor, Tensor]:
    """Stable (tile, depth) order of the pairs → (pair_tile_s, pair_gid_s).

    packed (the default when tile ids fit ≤ 20 bits): one key, the tile in
    the high bits and the float bits of max(depth, 1e-6) shifted right by
    tile_bits below, built in int64 and sorted stably, so pairs whose keys
    tie keep the order of gaussian ids, as `jax.lax.sort` keeps it.
    Otherwise two keys: a stable sort by depth, then a stable sort by
    tile."""
    tile_bits = max((n_tiles + 1).bit_length(), 1)
    if packed is None:
        packed = tile_bits <= 20
    if packed:
        dshift = 32 - tile_bits
        d32 = torch.clamp(pair_depth.to(torch.float32), min=1e-6)
        # a positive float's bits as int32 are ≥ 0 and monotone in it
        dbits = d32.view(torch.int32).to(torch.int64) >> tile_bits
        key = (pair_tile.to(torch.int64) << dshift) | dbits
        key_s, order = torch.sort(key, stable=True)
        return (key_s >> dshift).to(torch.int32), pair_gid[order]
    order = torch.sort(pair_depth, stable=True).indices
    order = order[torch.sort(pair_tile[order], stable=True).indices]
    return pair_tile[order], pair_gid[order]


def _tile_table(pair_tile_s: Tensor, pair_gid_s: Tensor, n_tiles: int,
                capacity: int, n: int) -> Tuple[Tensor, Tensor]:
    """Tile ranges of the sorted pairs → the [n_tiles, capacity] id table
    (n in empty slots) by 1 + n_tiles binary searches and a gather, and
    n_dropped_cap (the pairs past a tile's capacity)."""
    dev = pair_tile_s.device
    m_pairs = pair_tile_s.shape[0]
    first = torch.searchsorted(
        pair_tile_s, torch.arange(n_tiles + 1, dtype=pair_tile_s.dtype,
                                  device=dev), side="left")
    seg_len = first[1:] - first[:-1]
    n_dropped_cap = torch.sum(torch.clamp(seg_len - capacity, min=0))
    pos = first[:n_tiles, None] + torch.arange(capacity, device=dev)[None, :]
    valid = pos < first[1:, None]
    ids = pair_gid_s[torch.clamp(pos, max=m_pairs - 1)]
    table = torch.where(valid, ids, torch.full_like(ids, n))
    return table.to(torch.int64), n_dropped_cap


def _gather_attrs(table: Tensor, mean2d: Tensor, inv: Tensor, op: Tensor,
                  colors: Tensor, depth: Tensor) -> Tensor:
    """Per-(tile, slot) attributes [T, 11, K] (rows μx, μy, c00, c01, c11,
    opacity, r, g, b, depth, live); empty slots (id n) read a zero row.
    Its autograd is an index_add of the slot gradients onto the
    gaussians."""
    per = torch.cat([mean2d, inv[:, 0, 0, None], inv[:, 0, 1, None],
                     inv[:, 1, 1, None], op[:, None], colors, depth[:, None],
                     torch.ones_like(depth[:, None])], -1)       # [N, 11]
    per = torch.cat([per, torch.zeros_like(per[:1])], 0)         # + pad row
    return per[table].permute(0, 2, 1).contiguous()


def _tile_origins(th: int, tw: int, tile: int, like: Tensor) -> Tensor:
    t = torch.arange(th * tw, device=like.device)
    return torch.stack([(t % tw) * tile, (t // tw) * tile], -1).to(like.dtype)


def tiles_to_image(tiles_flat: Tensor, th: int, tw: int, tile: int,
                   hw: Tuple[int, int]) -> Tensor:
    """[th·tw, tile, tile, ...] → the [H, W, ...] image (cropped)."""
    img = tiles_flat.reshape((th, tw, tile, tile) + tiles_flat.shape[3:])
    img = img.transpose(1, 2).reshape((th * tile, tw * tile)
                                      + tiles_flat.shape[3:])
    return img[:hw[0], :hw[1]]


# -------------------------------------------------- B17 / B18: plain versions
def _alpha_parts(attrs: Tensor, origin: Tensor, tile: int,
                 alpha_floor: float):
    """dx, dy, G, raw, alpha, live of every (tile, pixel, slot) [T, P, K]."""
    dt, dev = attrs.dtype, attrs.device
    oy, ox = torch.meshgrid(torch.arange(tile, dtype=dt, device=dev) + 0.5,
                            torch.arange(tile, dtype=dt, device=dev) + 0.5,
                            indexing="ij")
    offs = torch.stack([ox, oy], -1).reshape(-1, 2)              # [P, 2]
    pix = origin[:, None, :] + offs[None]                        # [T, P, 2]

    def row(i):
        return attrs[:, None, i, :]                              # [T, 1, K]

    dx = pix[..., 0:1] - row(_A_MUX)
    dy = pix[..., 1:2] - row(_A_MUY)
    md = (dx ** 2 * row(_A_IC00) + dy ** 2 * row(_A_IC11)
          + 2 * dx * dy * row(_A_IC01))
    g = torch.exp(-0.5 * md)
    raw = row(_A_OP) * g
    alpha = torch.clamp(raw, 0.0, 0.999)
    live = (row(_A_LIVE) > 0.0) & (alpha > alpha_floor)
    alpha = torch.where(live, alpha, torch.zeros_like(alpha))
    return dx, dy, g, raw, alpha, live


def _exclusive_trans(alpha: Tensor) -> Tuple[Tensor, Tensor]:
    t = 1.0 - alpha + 1e-10
    trans = torch.cumprod(t, dim=-1)
    return t, torch.cat([torch.ones_like(trans[..., :1]), trans[..., :-1]],
                        -1)


def gs_blend_plain(attrs: Tensor, origin: Tensor, bg: Sequence[float],
                   tile: int, alpha_floor: float
                   ) -> Tuple[Tensor, Tensor, Tensor]:
    """B17's plain version, the JAX package's `blend_chunk` cumprod form:
    attrs [T, 11, K], origin [T, 2] → rgb [T, P, 3], acc [T, P], depth
    [T, P] (P = tile²). Differentiable by autograd."""
    _, _, _, _, alpha, _ = _alpha_parts(attrs, origin, tile, alpha_floor)
    _, trans = _exclusive_trans(alpha)
    vw = alpha * trans                                           # [T, P, K]
    cols = attrs[:, _A_CR:_A_CB + 1, :]                          # [T, 3, K]
    rgb = torch.einsum("tpk,tck->tpc", vw, cols)
    acc = torch.sum(vw, -1)
    dep = torch.sum(vw * attrs[:, None, _A_DEP, :], -1) \
        / torch.clamp(acc, min=1e-10)
    rgb = rgb + (1.0 - acc)[..., None] * _bg(bg, attrs)
    return rgb, acc, dep


def gs_blend_bwd_plain(attrs: Tensor, origin: Tensor, g_rgb: Tensor,
                       g_acc: Tensor, g_dep: Tensor, bg: Sequence[float],
                       tile: int, alpha_floor: float) -> Tensor:
    """B18's plain version, its formula written out (not autograd of B17):
    the upstream gradients rgb [T, P, 3], acc and depth [T, P] → the
    per-slot gradients [T, 11, K] (the live row's is 0).

    dL/dvw_k = g_acc + g_dep·(z_k − depth)/acc + Σ_c g_c·(c_k − bg_c);
    dL/dα_k = dvw_k·T_k − (Σ_{j>k} dvw_j·vw_j)/(1 − α_k + 1e-10), 0 where
    the slot is not live or raw α ≥ 0.999; then chained through
    α = op·exp(−½·md) and reduced over the tile's pixels."""
    dx, dy, g, raw, alpha, live = _alpha_parts(attrs, origin, tile,
                                               alpha_floor)
    t, trans = _exclusive_trans(alpha)
    vw = alpha * trans
    acc = torch.sum(vw, -1, keepdim=True)                        # [T, P, 1]
    a_ = torch.clamp(acc, min=1e-10)
    z = attrs[:, None, _A_DEP, :]
    dep = torch.sum(vw * z, -1, keepdim=True) / a_
    bg_t = _bg(bg, attrs)
    g_dep = g_dep[..., None]
    dvw = g_acc[..., None] + g_dep * (z - dep) / a_
    for c in range(3):
        dvw = dvw + g_rgb[..., c:c + 1] * (attrs[:, None, _A_CR + c, :]
                                           - bg_t[c])
    u = dvw * vw
    # Σ_{j>k} u_j: a reversed inclusive cumsum, shifted by one
    suffix = torch.flip(torch.cumsum(torch.flip(u, [-1]), -1), [-1])
    after = torch.cat([suffix[..., 1:], torch.zeros_like(suffix[..., :1])],
                      -1)
    dalpha = dvw * trans - after / t
    dalpha = torch.where(live & (raw < 0.999), dalpha,
                         torch.zeros_like(dalpha))
    dmd = dalpha * raw * (-0.5)

    def ic(i):
        return attrs[:, None, i, :]

    ddx = dmd * (2.0 * dx * ic(_A_IC00) + 2.0 * dy * ic(_A_IC01))
    ddy = dmd * (2.0 * dy * ic(_A_IC11) + 2.0 * dx * ic(_A_IC01))
    rows = [-ddx.sum(1), -ddy.sum(1), (dmd * dx * dx).sum(1),
            (dmd * 2.0 * dx * dy).sum(1), (dmd * dy * dy).sum(1),
            (dalpha * g).sum(1)]
    rows += [(g_rgb[..., c:c + 1] * vw).sum(1) for c in range(3)]
    rows += [(g_dep * vw / a_).sum(1), torch.zeros_like(rows[0])]
    return torch.stack(rows, 1)


# ----------------------------------------------- B17 / B18: the CUDA kernels
def _lib():
    vp, ci, cf = _build.VP, ctypes.c_int, ctypes.c_float
    return _build.load("gaussian_blend", {
        "gs_blend": [vp, vp, vp, vp, vp, ci, ci, ci, cf, cf, cf, cf, vp],
        "gs_blend_bwd": [vp, vp, vp, vp, vp, vp, vp, ci, ci, ci, cf, cf, cf,
                         cf, vp]})


def _check_args(attrs: Tensor, origin: Tensor, tile: int, what: str) -> None:
    if attrs.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {attrs.device}")
    if attrs.dim() != 3 or attrs.shape[1] != N_ATTR or \
            attrs.dtype != torch.float32:
        raise ValueError(f"{what}: attrs must be [T, {N_ATTR}, K] float32, "
                         f"got {tuple(attrs.shape)} {attrs.dtype}")
    if origin.shape != (attrs.shape[0], 2) or origin.dtype != torch.float32 \
            or origin.device != attrs.device:
        raise ValueError(f"{what}: origin must be [T, 2] float32 on "
                         f"{attrs.device}")
    if not 1 <= tile <= MAX_TILE:
        raise ValueError(f"{what}: tile {tile} outside [1, {MAX_TILE}] (one "
                         f"thread per pixel of a tile)")


def _fwd_cuda(attrs: Tensor, origin: Tensor, bg: Sequence[float],
              tile: int, alpha_floor: float
              ) -> Tuple[Tensor, Tensor, Tensor]:
    """B17 `gs_blend`: one block per tile, one thread per pixel."""
    _check_args(attrs, origin, tile, "gs_blend")
    attrs, origin = attrs.contiguous(), origin.contiguous()
    n_t, _, k = attrs.shape
    p = tile * tile
    rgb = torch.empty(n_t, p, 3, device=attrs.device, dtype=torch.float32)
    acc = torch.empty(n_t, p, device=attrs.device, dtype=torch.float32)
    dep = torch.empty(n_t, p, device=attrs.device, dtype=torch.float32)
    if n_t == 0:
        return rgb, acc, dep
    err = _lib().gs_blend(attrs.data_ptr(), origin.data_ptr(), rgb.data_ptr(),
                          acc.data_ptr(), dep.data_ptr(), n_t, k, tile,
                          *(float(c) for c in bg), float(alpha_floor),
                          _build.stream_ptr(attrs.device))
    _build.check(err, "gs_blend")
    _build.LAUNCHES["gs_blend"] += 1
    return rgb, acc, dep


# slots per back-to-front chunk of B18 (csrc/gaussian_blend.cu CHUNK_B)
_BWD_CHUNK = 16


def _bwd_cuda(attrs: Tensor, origin: Tensor, g_rgb: Tensor, g_acc: Tensor,
              g_dep: Tensor, bg: Sequence[float], tile: int,
              alpha_floor: float) -> Tensor:
    """B18 `gs_blend_bwd`: per-slot gradients [T, 11, K], reduced over each
    tile's pixels inside its block (no atomics)."""
    _check_args(attrs, origin, tile, "gs_blend_bwd")
    attrs, origin = attrs.contiguous(), origin.contiguous()
    n_t, _, k = attrs.shape
    p = tile * tile
    grads = (g_rgb, g_acc, g_dep)
    shapes = ((n_t, p, 3), (n_t, p), (n_t, p))
    if any(g.shape != s or g.device != attrs.device for g, s in
           zip(grads, shapes)):
        raise ValueError("gs_blend_bwd: upstream gradients must be rgb "
                         "[T, P, 3], acc and depth [T, P] on the attrs' "
                         "device")
    g_rgb, g_acc, g_dep = (g.to(torch.float32).contiguous() for g in grads)
    dattrs = torch.empty_like(attrs)
    if n_t == 0 or k == 0:
        return dattrs.zero_()
    threads = -(-p // 32) * 32
    n_chunks = -(-k // _BWD_CHUNK)
    # each thread's transmittance at every chunk start (walk 1 → re-walk)
    ckpt = torch.empty(n_t * n_chunks * threads, device=attrs.device,
                       dtype=torch.float32)
    err = _lib().gs_blend_bwd(
        attrs.data_ptr(), origin.data_ptr(), g_rgb.data_ptr(),
        g_acc.data_ptr(), g_dep.data_ptr(), dattrs.data_ptr(),
        ckpt.data_ptr(), n_t, k, tile, *(float(c) for c in bg),
        float(alpha_floor), _build.stream_ptr(attrs.device))
    _build.check(err, "gs_blend_bwd")
    _build.LAUNCHES["gs_blend_bwd"] += 1
    return dattrs


def _route(attrs: Tensor, cpu_fn, cuda_fn, what: str):
    if attrs.device.type == "cpu":
        return cpu_fn
    if attrs.device.type == "cuda":
        return cuda_fn
    raise ValueError(f"{what}: unsupported device {attrs.device}")


class _GSBlend(torch.autograd.Function):
    """B17 forward, B18 backward (the plain versions on a CPU tensor).
    The tile origins get no gradient."""

    @staticmethod
    def forward(ctx, attrs, origin, bg, tile, alpha_floor):
        ctx.cfg = (tuple(bg), tile, alpha_floor)
        ctx.save_for_backward(attrs, origin)
        fn = _route(attrs, gs_blend_plain, _fwd_cuda, "gs_blend")
        return fn(attrs, origin, ctx.cfg[0], tile, alpha_floor)

    @staticmethod
    @once_differentiable
    def backward(ctx, g_rgb, g_acc, g_dep):
        attrs, origin = ctx.saved_tensors
        n_t, p = attrs.shape[0], ctx.cfg[1] ** 2
        zeros = attrs.new_zeros
        g_rgb = zeros(n_t, p, 3) if g_rgb is None else g_rgb
        g_acc = zeros(n_t, p) if g_acc is None else g_acc
        g_dep = zeros(n_t, p) if g_dep is None else g_dep
        fn = _route(attrs, gs_blend_bwd_plain, _bwd_cuda, "gs_blend_bwd")
        dattrs = fn(attrs, origin, g_rgb, g_acc, g_dep, *ctx.cfg)
        return dattrs, None, None, None, None


def gs_blend(attrs: Tensor, origin: Tensor, bg: Sequence[float], tile: int,
             alpha_floor: float = 1.0 / 255.0
             ) -> Tuple[Tensor, Tensor, Tensor]:
    """The per-tile front-to-back blend (B17, with B18 as its backward):
    attrs [T, 11, K] f32, origin [T, 2] f32 → rgb [T, P, 3], acc [T, P],
    depth [T, P]. CPU tensor → the plain versions; CUDA tensor → the
    kernels, or raise."""
    return _GSBlend.apply(attrs, origin, tuple(float(c) for c in bg), tile,
                          alpha_floor)


def _tile_attrs(means: Tensor, scales: Tensor, quats: Tensor,
                opacities: Tensor, colors: Tensor, w2c: Tensor, intr: Tensor,
                hw: Tuple[int, int], tile: int, tiles_per_gaussian: int,
                tile_capacity: int):
    """Every stage before the blend: projection, pair expansion, sort,
    tile table and attribute gather. Returns (attrs [T, 11, K], origin
    [T, 2], n_dropped_pairs, (th, tw))."""
    h, w = hw
    n = means.shape[0]
    th, tw = -(-h // tile), -(-w // tile)
    n_tiles = th * tw
    win = int(math.isqrt(tiles_per_gaussian))
    if win * win != tiles_per_gaussian:
        raise ValueError("tiles_per_gaussian must be a square")

    proj = project_gaussians(means, scales, quats, w2c, intr)
    mean2d, cov2d, depth = proj["mean2d"], proj["cov2d"], proj["depth"]
    radius = _screen_radius(cov2d)
    on_screen = (proj["in_front"]
                 & (mean2d[:, 0] + radius > 0) & (mean2d[:, 0] - radius < w)
                 & (mean2d[:, 1] + radius > 0) & (mean2d[:, 1] - radius < h))
    with torch.no_grad():
        pair_tile, pair_gid, pair_depth, n_dropped_window = _expand_pairs(
            mean2d, radius, on_screen, depth, tile, th, tw, win)
        pair_tile_s, pair_gid_s = _sort_pairs(pair_tile, pair_depth,
                                              pair_gid, n_tiles)
        table, n_dropped_cap = _tile_table(pair_tile_s, pair_gid_s, n_tiles,
                                           tile_capacity, n)
    attrs = _gather_attrs(table, mean2d, _inv_cov2d(cov2d),
                          opacities.reshape(-1), colors, depth)
    return (attrs, _tile_origins(th, tw, tile, means),
            n_dropped_cap + n_dropped_window, (th, tw))


def rasterize_gaussians_tiled(means: Tensor, scales: Tensor, quats: Tensor,
                              opacities: Tensor, colors: Tensor,
                              w2c: Tensor, intr: Tensor, hw: Tuple[int, int],
                              bg_color=(0.0, 0.0, 0.0),
                              tile: int = 16,
                              tiles_per_gaussian: int = 16,
                              tile_capacity: int = 256,
                              alpha_floor: float = 1.0 / 255.0,
                              blend_backend: str = "pallas"
                              ) -> Dict[str, Tensor]:
    """Tile-binned splatting (see the module docstring).

    Static caps, both coverage bounds: a gaussian touching more than
    `tiles_per_gaussian` tiles loses its out-of-window tiles; a tile keeps
    only its nearest `tile_capacity` gaussians by depth. Returns {rgb
    [H,W,3], alpha, depth, n_dropped_pairs}.

    blend_backend: only "pallas", the JAX package's name for the kernel
    route that `gs_blend` takes. The JAX package's "xla" and "interpret"
    exist because its Pallas kernels run on the TPU alone; here they raise.
    """
    if blend_backend != "pallas":
        raise ValueError(f"blend_backend {blend_backend!r}: the port has one "
                         "blend route, 'pallas' (the B17/B18 kernels on CUDA "
                         "tensors, their plain versions on CPU tensors)")
    attrs, origin, n_dropped, (th, tw) = _tile_attrs(
        means, scales, quats, opacities, colors, w2c, intr, hw, tile,
        tiles_per_gaussian, tile_capacity)
    n_tiles = th * tw
    rgb_t, acc_t, dep_t = gs_blend(attrs.to(torch.float32),
                                   origin.to(torch.float32), bg_color, tile,
                                   alpha_floor)
    img = {k: tiles_to_image(v.reshape((n_tiles, tile, tile) + v.shape[2:]),
                             th, tw, tile, hw)
           for k, v in (("rgb", rgb_t), ("alpha", acc_t), ("depth", dep_t))}
    img["n_dropped_pairs"] = n_dropped
    return img


# ----------------------------------------------------- render equations
def render_equation_r3dg(base_color: Tensor, roughness: Tensor,
                         metallic: Tensor, normals: Tensor, viewdirs: Tensor,
                         incidents_shs: Tensor, direct_shs: Tensor,
                         visibility_shs: Tensor, sample_num: int = 24
                         ) -> Dict[str, Tensor]:
    """r3dg's relightable per-gaussian render equation: Monte-Carlo
    integration over a Fibonacci hemisphere of incident directions around
    each normal; per-gaussian SH local light, a global SH environment
    (0.5 + direct SH) modulated by an SH visibility (0.5 + vis SH, clamped
    to [0,1]); Lambertian diffuse plus a spherical-Gaussian GGX specular
    with Schlick Fresnel and Smith-Schlick V; transport = light ·
    2π·(n·i)/S.

    Shapes: base_color [N,3], roughness/metallic [N], normals/viewdirs
    [N,3] (unit, surface→eye), incidents_shs [N,S_i,3] (S_i ≤ 16),
    direct_shs [S_d,3], visibility_shs [N,S_v]. Returns {pbr, rgb_d,
    rgb_s, diffuse_light, accum, incident_dirs, incident_lights}.
    """
    dt, dev = base_color.dtype, base_color.device
    i = torch.arange(sample_num, dtype=dt, device=dev)
    delta = math.pi * (3.0 - math.sqrt(5.0))
    z = 1.0 - 2.0 * i / (2.0 * sample_num - 1.0)
    rad = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    th = delta * i
    local = torch.stack([torch.sin(th) * rad, torch.cos(th) * rad, z], -1)

    # rotate +z to each normal (explicit Rodrigues form)
    nx, ny, nz = normals[:, 0], normals[:, 1], normals[:, 2]
    v1, v2 = -ny, nx
    cp = torch.clamp(nz + 1.0, min=1e-7)
    row0 = torch.stack([1 - v2 * v2 / cp, v1 * v2 / cp, v2], -1)
    row1 = torch.stack([v1 * v2 / cp, 1 - v1 * v1 / cp, -v1], -1)
    row2 = torch.stack([-v2, v1, 1 - (v1 * v1 + v2 * v2) / cp], -1)
    rot = torch.stack([row0, row1, row2], -2)                     # [N,3,3]
    dirs = torch.einsum("nij,sj->nsi", rot, local)
    dirs = dirs / torch.clamp(torch.linalg.norm(dirs, dim=-1, keepdim=True),
                              min=1e-7)                           # [N,S,3]

    coef = sh_encode(dirs, 4)                                     # [N,S,16]
    s_i = incidents_shs.shape[1]
    local_light = torch.clamp(
        torch.einsum("nsk,nkc->nsc", coef[..., :s_i], incidents_shs), min=0.0)
    s_d = direct_shs.shape[0]
    global_light = torch.clamp(
        0.5 + torch.einsum("nsk,kc->nsc", coef[..., :s_d], direct_shs),
        min=0.0)
    s_v = visibility_shs.shape[1]
    vis = torch.clamp(0.5 + torch.einsum("nsk,nk->ns", coef[..., :s_v],
                                         visibility_shs), 0.0, 1.0)
    light = global_light * vis[..., None] + local_light           # [N,S,3]

    v = viewdirs[:, None, :]
    half = dirs + v
    half = half / torch.clamp(torch.linalg.norm(half, dim=-1, keepdim=True),
                              min=1e-7)
    h_d_n = torch.clamp(torch.sum(half * normals[:, None], -1), min=0.0)
    h_d_o = torch.clamp(torch.sum(half * v, -1), min=0.0)
    n_d_i = torch.clamp(torch.sum(normals[:, None] * dirs, -1), min=0.0)
    n_d_o = torch.clamp(torch.sum(normals * viewdirs, -1), min=0.0)[:, None]

    m = metallic[:, None, None]
    f_d = (1 - m) * base_color[:, None] / math.pi
    r2 = torch.clamp(roughness ** 2, min=1e-7)[:, None]
    d_ggx = torch.exp(2.0 / r2 * (h_d_n - 1.0)) / (r2 * math.pi)
    f0 = 0.04 * (1 - m) + base_color[:, None] * m
    fres = f0 + (1 - f0) * (1 - h_d_o[..., None]) ** 5
    k = ((1.0 + roughness) ** 2 / 8.0)[:, None]
    vis_term = (0.5 / torch.clamp(n_d_i * (1 - k) + k, min=1e-7)) \
        * (0.5 / torch.clamp(n_d_o * (1 - k) + k, min=1e-7))
    f_s = d_ggx[..., None] * fres * vis_term[..., None]

    tmp = (2.0 * math.pi * n_d_i / sample_num)[..., None]
    transport = light * tmp
    diffuse_light = torch.sum(transport, 1)
    rgb_d = torch.sum(f_d * transport, 1)
    rgb_s = torch.sum(f_s * transport, 1)
    accum = torch.mean(diffuse_light / math.pi + rgb_s, -1)
    return {"pbr": rgb_d + rgb_s, "rgb_d": rgb_d, "rgb_s": rgb_s,
            "diffuse_light": diffuse_light, "accum": accum,
            "incident_dirs": dirs, "incident_lights": light}


def render_equation(base_color: Tensor, roughness: Tensor, normals: Tensor,
                    view_dirs: Tensor, light_dirs: Tensor, light_rgb: Tensor,
                    ambient: float = 0.1) -> Tensor:
    """Per-gaussian simplified directional-light shading (the cheap
    point-light path; the full render equation is `render_equation_r3dg`).

    base_color [N,3], roughness [N], normals [N,3] (unit), view_dirs [N,3]
    (surface→eye), light_dirs [N,3] (surface→light).
    """
    n = normals

    def unit(x):
        return x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True),
                               min=1e-8)

    l_, v = unit(light_dirs), unit(view_dirs)
    ndl = torch.clamp(torch.sum(n * l_, -1), min=0.0)
    half = unit(l_ + v)
    ndh = torch.clamp(torch.sum(n * half, -1), min=0.0)
    shininess = 2.0 / torch.clamp(roughness ** 2, min=1e-3)
    spec = torch.pow(ndh, shininess) * (1.0 - roughness)
    diffuse = base_color * ndl[..., None]
    return ambient * base_color + (diffuse + spec[..., None]) * light_rgb
