"""B17's per-warp cull (`csrc/gaussian_blend.cu` `gs_blend`), through its
plain mirror `gs_blend_cull_plain` (float32, the kernel's formula): a
warp may skip a slot only where no pixel of the warp takes it, that is
where the plain α (`_alpha_parts`, the blend's plain version) is at or
below the floor at every pixel of the warp. The kernel itself runs only
on a card (`tests/test_torch_kernels_gpu.py`, and `chip_ab.py`, which
holds its outputs bitwise against the kernel without the cull).

Random tiles (hypothesis: conics of σ 0.05–20 px at any angle, indefinite
and singular ones, opacities from −0.1 to 1.5, dead slots, centres in and
around the tile), adversarial slots whose α at the pixel nearest the
warp's box lies within a few ulps of the floor on either side (where the
bound is tight: isotropic conics, or the smaller eigenvalue's axis
pointing at the nearest pixel), and a scene of the bench's distributions
at a small size. No tolerance: one skipped slot that a pixel takes fails.
"""

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings, strategies as st

from nr3d_lib_tpu_torch.graphics import gaussian_splatting as GS
from torch_gs_tiles import near_floor_tiles

FLOOR = 1.0 / 255.0
F32 = np.float32


def _taken(attrs, origin, tile, floor=FLOOR):
    """[T, W, K]: some pixel of warp w takes slot k (α above the floor)."""
    live = GS._alpha_parts(attrs, origin, tile, floor)[5]         # [T, P, K]
    wp = GS._warp_pixels(tile)
    got = live[:, wp.clamp(min=0).view(-1)].view(
        live.shape[0], *wp.shape, live.shape[-1])
    return (got & (wp >= 0)[None, :, :, None]).any(2)


def _conservative(attrs, origin, tile, floor=FLOOR):
    keep = GS.gs_blend_cull_plain(attrs, origin, tile, floor)
    taken = _taken(attrs, origin, tile, floor)
    assert keep.shape == taken.shape == (attrs.shape[0],
                                         GS._warp_pixels(tile).shape[0],
                                         attrs.shape[2])
    bad = (taken & ~keep).nonzero().tolist()
    assert not bad, f"skipped (tile, warp, slot) that a pixel takes: {bad}"
    return keep, taken


def _conic(s1, s2, theta):
    """The inverse of R diag(s1², s2²) Rᵀ → (c00, c01, c11)."""
    c, s = np.cos(theta), np.sin(theta)
    r = np.array([[c, -s], [s, c]])
    inv = r @ np.diag([1.0 / s1 ** 2, 1.0 / s2 ** 2]) @ r.T
    return inv[0, 0], inv[0, 1], inv[1, 1]


def _tile(slots, tile, origin):
    """attrs [1, 11, K] and origin [1, 2] from (mx, my, c00, c01, c11, op,
    live) per slot; colours and depths fixed."""
    k = len(slots)
    a = np.zeros((1, 11, k), F32)
    for j, (mx, my, c00, c01, c11, op, live) in enumerate(slots):
        a[0, :, j] = [origin[0] + mx, origin[1] + my, c00, c01, c11, op,
                      0.2, 0.5, 0.9, 1.0 + j, live]
    return torch.from_numpy(a), torch.tensor([origin], dtype=torch.float32)


_slot = st.tuples(
    st.floats(-2.0, 3.0), st.floats(-2.0, 3.0),        # centre / tile
    st.floats(0.05, 20.0), st.floats(0.05, 20.0),      # σ in px
    st.floats(0.0, np.pi),                             # angle
    st.floats(-0.1, 1.5),                              # opacity
    st.sampled_from(["live", "live", "live", "dead", "indefinite",
                     "singular"]))


@settings(max_examples=60, deadline=None, database=None, derandomize=True,
          suppress_health_check=[HealthCheck.too_slow])
@given(tile=st.sampled_from([8, 16]), gx=st.integers(0, 31),
       gy=st.integers(0, 31), raw=st.lists(_slot, min_size=1, max_size=48))
def test_cull_never_skips_a_taken_slot_random(tile, gx, gy, raw):
    slots = []
    for fx, fy, s1, s2, th, op, kind in raw:
        c00, c01, c11 = _conic(s1, s2, th)
        if kind == "indefinite":
            c01 = np.sqrt(c00 * c11) * 1.5
        elif kind == "singular":
            c01 = np.sqrt(c00 * c11)
        slots.append((fx * tile, fy * tile, c00, c01, c11, op,
                      0.0 if kind == "dead" else 1.0))
    _conservative(*_tile(slots, tile, (gx * tile, gy * tile)), tile)


@pytest.mark.parametrize("tile", [5, 8, 12, 16, 32])
def test_cull_never_skips_a_taken_slot_near_the_floor(tile):
    """Slots whose α at the pixel of a warp's box nearest their centre is
    within ulps of the floor on either side, where the bound is tight (the
    GPU tests' tiles: off a corner along a rotated conic's smaller
    eigenvalue's axis, or off an edge with an isotropic conic): every
    slot that a pixel takes is kept, and the tiles hold slots on both
    sides of the floor."""
    a, origin, target = near_floor_tiles(torch.device("cpu"), 4, 64, tile,
                                         seed=tile + 50)
    _conservative(a, origin, tile)
    live = GS._alpha_parts(a, origin, tile, FLOOR)[5]
    at = torch.gather(live, 1, target[:, None, :])[:, 0]
    assert at.any() and not at.all()


@pytest.mark.parametrize("tile", [8, 16])
def test_cull_at_the_bench_distributions(tile):
    """bench.py S5's distributions (means U[-1,1], scales U[0.002, 0.02],
    opacities U[0.3, 0.9], camera at z = 3, f = 500) at 30,000 gaussians
    and a 128² crop: no taken (warp, slot) pair is skipped, so the cull
    keeps no fewer pairs than are taken, and it skips some live ones."""
    r = np.random.default_rng(21)
    n = 30_000
    q = r.normal(size=(n, 4))
    p = {"means": r.uniform(-1.0, 1.0, (n, 3)),
         "scales": r.uniform(0.002, 0.02, (n, 3)),
         "quats": q / np.linalg.norm(q, axis=-1, keepdims=True),
         "opac": r.uniform(0.3, 0.9, (n, 1)),
         "cols": r.uniform(0.0, 1.0, (n, 3))}
    p = {k: torch.from_numpy(v.astype(F32)) for k, v in p.items()}
    w2c = torch.eye(4)
    w2c[2, 3] = 3.0
    intr = torch.tensor([[500.0, 0, 64], [0, 500.0, 64], [0, 0, 1]])
    with torch.no_grad():
        attrs, origin, _, _ = GS._tile_attrs(
            p["means"], p["scales"], p["quats"], p["opac"], p["cols"], w2c,
            intr, (128, 128), tile=tile, tiles_per_gaussian=16,
            tile_capacity=256)
    keep, taken = _conservative(attrs, origin, tile)
    live_pairs = int((attrs[:, 10] > 0).sum()) * keep.shape[1]
    assert int(taken.sum()) <= int(keep.sum()) < live_pairs


def test_cull_keeps_what_it_cannot_bound():
    """A non-finite colour keeps even a dead slot (0·inf is NaN, not a
    no-op); a live slot with λ_min ≤ 0 or a non-finite conic is kept
    wherever it lies; a floor ≤ 0 keeps every live slot; a dead slot with
    finite colours is skipped everywhere."""
    far = 1000.0
    slots = [(far, far, 1.0, 0.0, 1.0, 0.5, 0.0),         # dead: skipped
             (far, far, 1.0, 0.0, 1.0, 0.5, 0.0),         # dead, NaN colour
             (far, far, 1.0, 2.0, 1.0, 0.5, 1.0),         # indefinite
             (far, far, -1.0, 0.0, 1.0, 0.5, 1.0),        # negative
             (far, far, np.inf, 0.0, 1.0, 0.5, 1.0),      # non-finite conic
             (far, far, 1.0, 0.0, 1.0, 0.5, 1.0)]         # live: skipped
    attrs, origin = _tile(slots, 16, (0.0, 0.0))
    attrs[0, 6, 1] = float("nan")
    keep = GS.gs_blend_cull_plain(attrs, origin, 16, FLOOR)[0]   # [W, K]
    assert keep.all(0).tolist() == [False, True, True, True, True, False]
    assert keep.any(0).tolist() == keep.all(0).tolist()
    keep0 = GS.gs_blend_cull_plain(attrs, origin, 16, 0.0)[0]
    assert keep0.all(0).tolist() == [False, True, True, True, True, True]


@pytest.mark.parametrize("tile", [1, 5, 8, 12, 16, 24, 32])
def test_warp_pixels_cover_the_tile_once(tile):
    """B17's thread-to-pixel map: every pixel once; where 8 divides the
    tile each warp is an 8 x 4 box (tile 8: the row-major order)."""
    wp = GS._warp_pixels(tile)
    assert wp.shape == (-(-tile * tile // 32), 32)
    assert sorted(wp[wp >= 0].tolist()) == list(range(tile * tile))
    if tile % 8 == 0:
        for w in wp:
            x, y = w % tile, w // tile
            assert x.max() - x.min() == 7 and y.max() - y.min() == 3
    if tile in (1, 5, 8, 12):
        assert wp[wp >= 0].tolist() == list(range(tile * tile))
