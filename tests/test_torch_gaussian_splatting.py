"""The port's Gaussian splatting (graphics/gaussian_splatting.py,
maths/transforms.py) against the JAX package on the CPU.

Every input is made by numpy and pinned to float32, the camera included
(the suite's conftest turns on x64, and a float64 `w2c` or `intr` would put
the JAX side in float64). The blend kernels' plain versions (B17
`gs_blend_plain`, B18 `gs_blend_bwd_plain`) are held against the JAX
package's Pallas kernels run in interpret mode, at a few tiles and small
capacities; the whole tiled rasterizer, on CPU tensors, against JAX's
"xla" route and `jax.grad` through it.

Tolerances: transforms 1e-6 (the same formulas); projection and SH 1e-5
relative (einsums summed in another order); blends 2e-5 (the TPU kernel's
Hillis-Steele scans and sums run in another order than a cumprod);
gradients 5e-5 of the largest entry of each tensor (the same, through
the suffix sums of the backward). The pair order under exact depth ties,
the tile table and `n_dropped_pairs` are exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nr3d_lib_tpu.graphics import gaussian_splatting as JG
from nr3d_lib_tpu.maths import transforms as JT
from nr3d_lib_tpu_torch import bridge
from nr3d_lib_tpu_torch.graphics import gaussian_splatting as PG
from nr3d_lib_tpu_torch.maths import transforms as PT

F32 = np.float32


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _close(a, b, atol, rtol=0.0, msg=""):
    np.testing.assert_allclose(_np(a), _np(b), atol=atol, rtol=rtol,
                               err_msg=msg)


def _rel_close(a, b, tol, msg=""):
    """|a − b| ≤ tol · max|b| (+ a floor for all-zero tensors)."""
    a, b = _np(a), _np(b)
    scale = float(np.abs(b).max()) + 1e-12
    np.testing.assert_allclose(a / scale, b / scale, atol=tol, err_msg=msg)


def _scene(n, seed, spread=1.0, scale=0.05, aniso=True):
    """means U[-spread, spread]³, anisotropic scales (so the quats get a
    gradient), unit quats, opacities U[0.3, 0.9], colours U[0, 1]."""
    r = np.random.default_rng(seed)
    means = r.uniform(-spread, spread, (n, 3))
    shape = (n, 3) if aniso else (n, 1)
    scales = scale * r.uniform(0.5, 1.5, shape) * np.ones((n, 3))
    q = r.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    opac = r.uniform(0.3, 0.9, (n,))
    cols = r.uniform(0.0, 1.0, (n, 3))
    return tuple(a.astype(F32) for a in (means, scales, q, opac, cols))


def _camera(f=80.0, cx=32.0, cy=32.0, dist=4.0):
    w2c = np.eye(4, dtype=F32)
    w2c[2, 3] = dist
    intr = np.array([[f, 0, cx], [0, f, cy], [0, 0, 1]], F32)
    return w2c, intr


def _jt(arrs):
    return tuple(jnp.asarray(a) for a in arrs)


def _pt(arrs, grad=False):
    return tuple(torch.from_numpy(a.copy()).requires_grad_(grad)
                 for a in arrs)


# ---------------------------------------------------------------- transforms
def test_transforms_match_jax():
    r = np.random.default_rng(0)
    q = r.normal(size=(64, 4)).astype(F32)
    assert PT.__all__ == JT.__all__             # all of them since A14
    _close(PT.quaternion_to_matrix(torch.from_numpy(q)),
           JT.quaternion_to_matrix(jnp.asarray(q)), atol=1e-6, rtol=1e-6,
           msg="quaternion_to_matrix")


# ------------------------------------------------------ projection and SH
def test_projection_stages_match_jax():
    means, scales, quats, _, _ = _scene(300, 1, spread=1.5, scale=0.08)
    means[0] = [0.0, 0.0, -5.0]                    # behind the camera
    w2c, intr = _camera()
    pj = JG.project_gaussians(*_jt((means, scales, quats, w2c, intr)))
    pp = PG.project_gaussians(*_pt((means, scales, quats, w2c, intr)))
    for k in ("mean2d", "cov2d", "depth"):
        _close(pp[k], pj[k], atol=1e-5 * float(np.abs(_np(pj[k])).max()),
               msg=k)
    assert np.array_equal(_np(pp["in_front"]), _np(pj["in_front"]))
    assert not bool(pp["in_front"][0])
    cov = _np(pj["cov2d"]).astype(F32)
    for fn in ("_screen_radius", "_inv_cov2d"):
        want = getattr(JG, fn)(jnp.asarray(cov))
        got = getattr(PG, fn)(torch.from_numpy(cov))
        _close(got, want, atol=1e-5 * float(np.abs(_np(want)).max()), msg=fn)
    vis_j = JG.mark_visible(*_jt((means, w2c, intr)), (64, 64))
    vis_p = PG.mark_visible(*_pt((means, w2c, intr)), (64, 64))
    assert np.array_equal(_np(vis_p), _np(vis_j))
    assert 0 < int(vis_p.sum()) < means.shape[0]


@pytest.mark.parametrize("k", [1, 4, 9, 16])
def test_sh_colors_match_jax(k):
    r = np.random.default_rng(k)
    shs = (r.normal(size=(32, k, 3)) * 0.3).astype(F32)
    dirs = r.normal(size=(32, 3)).astype(F32)
    want = JG.eval_sh_colors(*_jt((shs, dirs)))
    got = PG.eval_sh_colors(*_pt((shs, dirs)))
    _close(got, want, atol=1e-5 * float(np.abs(_np(want)).max()), rtol=1e-5)


def test_dense_rasterizer_matches_jax():
    scene = _scene(200, 2, scale=0.06)
    w2c, intr = _camera(cx=24.0, cy=16.0)
    kw = dict(bg_color=(0.2, 0.1, 0.05), pixel_chunk=512)
    want = jax.jit(lambda *a: JG.rasterize_gaussians(*a, (32, 48), **kw))(
        *_jt(scene), *_jt((w2c, intr)))
    got = PG.rasterize_gaussians(*_pt(scene), *_pt((w2c, intr)), (32, 48),
                                 **kw)
    assert float(_np(want["alpha"]).max()) > 0.5
    for k in ("rgb", "alpha", "depth"):
        _close(got[k], want[k], atol=2e-5, msg=k)


# ------------------------------------------------ the tiled pipeline stages
def _jax_stages(scene, w2c, intr, hw, tile, tpg, cap):
    """The JAX module's pair expansion, packed sort and tile table
    (`rasterize_gaussians_tiled`, gaussian_splatting.py:436-515), stage by
    stage (the module computes them inline), under one `jax.jit`."""
    return jax.jit(lambda *a: _jax_stage_arrays(*a, hw, tile, tpg, cap))(
        *_jt(scene[:3]), *_jt((w2c, intr)))


def _jax_stage_arrays(means, scales, quats, w2c, intr, hw, tile, tpg, cap):
    h, w = hw
    n = means.shape[0]
    th, tw = -(-h // tile), -(-w // tile)
    n_tiles = th * tw
    win = int(np.sqrt(tpg))
    proj = JG.project_gaussians(means, scales, quats, w2c, intr)
    mean2d, depth = proj["mean2d"], proj["depth"]
    radius = JG._screen_radius(proj["cov2d"])
    on = (proj["in_front"] & (mean2d[:, 0] + radius > 0)
          & (mean2d[:, 0] - radius < w) & (mean2d[:, 1] + radius > 0)
          & (mean2d[:, 1] - radius < h))
    t0x = jnp.floor((mean2d[:, 0] - radius) / tile).astype(jnp.int32)
    t0y = jnp.floor((mean2d[:, 1] - radius) / tile).astype(jnp.int32)
    t1x = jnp.floor((mean2d[:, 0] + radius) / tile).astype(jnp.int32)
    t1y = jnp.floor((mean2d[:, 1] + radius) / tile).astype(jnp.int32)
    d = jnp.arange(win, dtype=jnp.int32)
    tx = jnp.broadcast_to(t0x[:, None, None] + d[None, None, :],
                          (n, win, win))
    ty = jnp.broadcast_to(t0y[:, None, None] + d[None, :, None],
                          (n, win, win))
    ok = (on[:, None, None] & (tx >= 0) & (tx < tw) & (ty >= 0) & (ty < th)
          & (tx <= t1x[:, None, None]) & (ty <= t1y[:, None, None]))
    n_win = jnp.sum(jnp.maximum(
        (jnp.clip(t1x, 0, tw - 1) - jnp.maximum(t0x, 0) + 1)
        * (jnp.clip(t1y, 0, th - 1) - jnp.maximum(t0y, 0) + 1) - tpg, 0)
        * on)
    pair_tile = jnp.where(ok, ty * tw + tx, n_tiles).reshape(-1)
    pair_gid = jnp.broadcast_to(jnp.arange(n, dtype=jnp.int32)[:, None, None],
                                (n, win, win)).reshape(-1)
    pair_depth = jnp.broadcast_to(depth[:, None, None],
                                  (n, win, win)).reshape(-1)
    tile_s, gid_s = _jax_sort(pair_tile, pair_depth, pair_gid, n_tiles, True)
    first = jnp.searchsorted(tile_s, jnp.arange(n_tiles + 1,
                                                dtype=tile_s.dtype),
                             side="left")
    seg = first[1:] - first[:-1]
    n_cap = jnp.sum(jnp.maximum(seg - cap, 0))
    pos = first[:n_tiles, None] + jnp.arange(cap, dtype=jnp.int32)[None, :]
    table = jnp.where(pos < first[1:, None],
                      gid_s[jnp.minimum(pos, tile_s.shape[0] - 1)], n)
    return dict(pair_tile=pair_tile, pair_gid=pair_gid, pair_depth=pair_depth,
                n_win=n_win, tile_s=tile_s, gid_s=gid_s, table=table,
                n_cap=n_cap, mean2d=mean2d, radius=radius, on=on,
                depth=depth)


def _jax_sort(pair_tile, pair_depth, pair_gid, n_tiles, packed):
    """gaussian_splatting.py:488-499, both branches."""
    tile_bits = max((n_tiles + 1).bit_length(), 1)
    if packed:
        dshift = jnp.uint32(32 - tile_bits)
        dbits = jax.lax.bitcast_convert_type(
            jnp.maximum(pair_depth.astype(jnp.float32), 1e-6),
            jnp.uint32) >> jnp.uint32(tile_bits)
        key = (pair_tile.astype(jnp.uint32) << dshift) | dbits
        key_s, gid_s = jax.lax.sort((key, pair_gid), num_keys=1)
        return (key_s >> dshift).astype(jnp.int32), gid_s
    tile_s, _, gid_s = jax.lax.sort((pair_tile, pair_depth, pair_gid),
                                    num_keys=2)
    return tile_s, gid_s


@pytest.mark.parametrize("packed", [True, False])
def test_sort_pairs_matches_lax_sort_under_ties(packed):
    r = np.random.default_rng(3)
    m, n_tiles = 4000, 37
    tile = r.integers(0, n_tiles + 1, m).astype(np.int32)  # n_tiles = dead
    # few distinct depths: exact ties, and ties of the packed key's top
    # bits (depths one ulp apart)
    depth = r.choice(np.array([0.5, 1.0, 1.0 + 2 ** -23, 2.0, 3.25, 1e-9],
                              F32), m)
    gid = (np.arange(m) // 4).astype(np.int32)
    want = _jax_sort(*_jt((tile, depth, gid)), n_tiles, packed)
    got = PG._sort_pairs(*_pt((tile, depth, gid)), n_tiles, packed=packed)
    for g, w in zip(got, want):
        assert np.array_equal(_np(g).astype(np.int64), _np(w).astype(np.int64))
    if packed:      # the default at ≤ 20 tile bits
        default = PG._sort_pairs(*_pt((tile, depth, gid)), n_tiles)
        assert all(torch.equal(a, b) for a, b in zip(default, got))


@pytest.mark.parametrize("cap", [4, 200])
def test_tile_table_and_dropped_pairs_match_jax(cap):
    """A cloud piled on a few tiles (cap 4 truncates, 200 does not), wide
    gaussians that overflow the 2×2 window, and one gaussian behind the
    camera."""
    scene = list(_scene(150, 4, spread=0.6, scale=0.05))
    scene[0][0] = [0.0, 0.0, -6.0]
    scene[1][1:4] = 0.6                           # bboxes beyond the window
    w2c, intr = _camera(f=60.0, cx=20.0, cy=15.0)
    hw, tile, tpg = (30, 40), 8, 4
    ref = _jax_stages(scene, w2c, intr, hw, tile, tpg, cap)
    th, tw, win = -(-hw[0] // tile), -(-hw[1] // tile), 2
    pp = PG.project_gaussians(*_pt(scene[:3]), *_pt((w2c, intr)))
    radius = PG._screen_radius(pp["cov2d"])
    _close(radius, ref["radius"], atol=1e-5 * float(ref["radius"].max()))
    # the stages from JAX's own projection, so the comparison is exact
    pt, pg, pd, n_win = PG._expand_pairs(
        torch.from_numpy(_np(ref["mean2d"]).copy()),
        torch.from_numpy(_np(ref["radius"]).copy()),
        torch.from_numpy(_np(ref["on"]).copy()),
        torch.from_numpy(_np(ref["depth"]).copy()), tile, th, tw, win)
    for a, b in ((pt, "pair_tile"), (pg, "pair_gid"), (pd, "pair_depth")):
        assert np.array_equal(_np(a), _np(ref[b])), b
    assert int(n_win) == int(ref["n_win"]) > 0
    n_tiles = th * tw
    ts, gs = PG._sort_pairs(pt, pd, pg, n_tiles)
    assert np.array_equal(_np(ts), _np(ref["tile_s"]))
    assert np.array_equal(_np(gs), _np(ref["gid_s"]))
    table, n_cap = PG._tile_table(ts, gs, n_tiles, cap, 150)
    assert np.array_equal(_np(table), _np(ref["table"]))
    assert int(n_cap) == int(ref["n_cap"])
    assert (int(n_cap) > 0) == (cap == 4)
    # and end to end, through both rasterizers
    kw = dict(tile=tile, tiles_per_gaussian=tpg, tile_capacity=cap)
    dj = jax.jit(lambda *a: JG.rasterize_gaussians_tiled(*a, hw, **kw)[
        "n_dropped_pairs"])(*_jt(scene), *_jt((w2c, intr)))
    dp = PG.rasterize_gaussians_tiled(*_pt(scene), *_pt((w2c, intr)), hw,
                                      **kw)["n_dropped_pairs"]
    assert int(dp) == int(dj) == int(ref["n_cap"]) + int(ref["n_win"])


def test_tiles_to_image_and_routes():
    x = torch.arange(6 * 4 * 4, dtype=torch.float32).reshape(6, 4, 4)
    img = PG.tiles_to_image(x, 2, 3, 4, (7, 10))
    assert img.shape == (7, 10)
    assert float(img[5, 9]) == float(x[5, 1, 1])      # tile (1, 2), (1, 1)
    scene = _scene(8, 0)
    for backend in ("xla", "interpret", "mosaic"):
        with pytest.raises(ValueError, match="one blend route"):
            PG.rasterize_gaussians_tiled(*_pt(scene), *_pt(_camera()),
                                         (16, 16), blend_backend=backend)


# ---------------------------------------------- B17 / B18 plain versions
def _blend_inputs(n_t, k, tile, seed):
    """Per-tile attrs [T, 11, K]: centres in and around the tile, random
    SPD inverse covariances (σ 1–6 px), depths increasing along the slots,
    a quarter of the slots dead (the zero pad row), a few opacities of 1.2
    (raw α ≥ 0.999 at the centre); origins on a grid; upstream gradients."""
    r = np.random.default_rng(seed)
    origin = np.stack([(np.arange(n_t) % 3) * tile,
                       (np.arange(n_t) // 3) * tile], -1).astype(F32)
    a = np.zeros((n_t, 11, k), F32)
    mu = origin[:, :, None] + r.uniform(-0.3 * tile, 1.3 * tile, (n_t, 2, k))
    sig = r.uniform(1.0, 6.0, (n_t, 2, k))
    rho = r.uniform(-0.6, 0.6, (n_t, k))
    det = sig[:, 0] ** 2 * sig[:, 1] ** 2 * (1 - rho ** 2)
    cxy = rho * sig[:, 0] * sig[:, 1]
    a[:, 0:2] = mu
    a[:, 2] = sig[:, 1] ** 2 / det
    a[:, 3] = -cxy / det
    a[:, 4] = sig[:, 0] ** 2 / det
    a[:, 5] = r.uniform(0.3, 0.95, (n_t, k))
    a[:, 5, 1::9] = 1.2
    a[:, 6:9] = r.uniform(0, 1, (n_t, 3, k))
    a[:, 9] = np.sort(r.uniform(1.0, 5.0, (n_t, k)), -1)
    a[:, 10] = 1.0
    a[:, :, 3 * k // 4:] = 0.0                          # dead tail slots
    p = tile * tile
    g = (r.normal(size=(n_t, p, 3)).astype(F32),
         r.normal(size=(n_t, p)).astype(F32),
         (0.1 * r.normal(size=(n_t, p))).astype(F32))
    return a, origin, g


BG = (0.3, 0.2, 0.7)
FLOOR = 1.0 / 255.0


def _pad16(a):
    return jnp.asarray(np.concatenate(
        [a, np.zeros((a.shape[0], 5, a.shape[2]), F32)], 1))


@pytest.mark.parametrize("k", [32, 64])
def test_plain_blend_matches_pallas_interpret(k):
    from jax.experimental.pallas import tpu as pltpu

    a, origin, _ = _blend_inputs(4, k, 16, seed=k)
    with pltpu.force_tpu_interpret_mode():
        want = JG._blend_tiles_pallas_raw(_pad16(a), jnp.asarray(origin), BG,
                                          16, FLOOR, interpret=True)
    got = PG.gs_blend_plain(*_pt((a, origin)), BG, 16, FLOOR)
    assert float(_np(want[1]).max()) > 0.9              # saturated pixels
    for g, w, name in zip(got, want, ("rgb", "acc", "depth")):
        _close(g, w, atol=2e-5, msg=name)


@pytest.mark.parametrize("k", [32, 64])
def test_plain_blend_bwd_matches_pallas_interpret(k):
    from jax.experimental.pallas import tpu as pltpu

    a, origin, g = _blend_inputs(4, k, 16, seed=10 + k)
    with pltpu.force_tpu_interpret_mode():
        want, d_origin = JG._blend_bwd(BG, 16, FLOOR, True,
                                       (_pad16(a), jnp.asarray(origin)),
                                       _jt(g))
    assert not np.any(_np(d_origin))
    got = PG.gs_blend_bwd_plain(*_pt((a, origin)), *_pt(g), BG, 16, FLOOR)
    want = _np(want)[:, :11]
    for r in range(10):
        _rel_close(got[:, r], want[:, r], 5e-5, msg=f"row {r}")
    assert not np.any(_np(got[:, 10]))
    assert not np.any(_np(got[:, :, 3 * k // 4:]))      # dead slots


def _liveness_tile(k, sat_slot):
    """One 16² tile whose slots differ in where they are live: slot 0
    below the α floor at every pixel (opacity 0.003 < 1/255), slot 1 live
    on only the first 32 pixels (pixel rows 0–1: σ 0.4 px at y = 1), slot
    `sat_slot` opacity 1.0 and σ 1000 px (raw α ≥ 0.999 at every pixel),
    the rest ordinary gaussians and a dead tail."""
    a, origin, g = _blend_inputs(1, k, 16, seed=40 + sat_slot)
    origin[:] = 0.0
    a[0, :, 0] = [8.0, 8.0, 1 / 9.0, 0.0, 1 / 9.0, 0.003, 0.2, 0.5, 0.9,
                  a[0, 9, 0], 1.0]
    a[0, :, 1] = [8.0, 1.0, 6.25, 0.0, 6.25, 0.9, 0.8, 0.1, 0.3, a[0, 9, 1],
                  1.0]
    a[0, :, sat_slot] = [8.0, 8.0, 1e-6, 0.0, 1e-6, 1.0, 0.4, 0.6, 0.2,
                         a[0, 9, sat_slot], 1.0]
    return a, origin, g


@pytest.mark.parametrize("sat_slot", [2, 20])
def test_plain_blend_bwd_slot_liveness_matches_pallas_interpret(sat_slot):
    """The invariant B18's warp vote rests on: a slot that is live on no
    pixel of a warp adds exactly 0 there. A slot below the floor
    everywhere gets exactly 0 in every row; a saturated live slot gets 0
    in rows 0–5 (dL/dα is masked) but not in r, g, b, depth; a slot live
    on one warp's pixels only gets gradients from those pixels alone."""
    from jax.experimental.pallas import tpu as pltpu

    k = 32
    a, origin, g = _liveness_tile(k, sat_slot)
    live = PG._alpha_parts(*_pt((a, origin)), 16, FLOOR)[5][0]  # [P, K]
    assert not live[:, 0].any()
    assert live[:32, 1].any() and not live[32:, 1].any()
    assert live[:, sat_slot].all()
    with pltpu.force_tpu_interpret_mode():
        want, _ = JG._blend_bwd(BG, 16, FLOOR, True,
                                (_pad16(a), jnp.asarray(origin)), _jt(g))
    want = _np(want)[:, :11]
    got = PG.gs_blend_bwd_plain(*_pt((a, origin)), *_pt(g), BG, 16, FLOOR)
    for r in range(10):
        _rel_close(got[:, r], want[:, r], 5e-5, msg=f"row {r}")
    # slot 1 from the first warp's pixels alone: the other pixels' upstream
    # gradients do not reach it
    g_warp0 = tuple(x.copy() for x in g)
    for x in g_warp0:
        x[:, 32:] = 0.0
    got0 = PG.gs_blend_bwd_plain(*_pt((a, origin)), *_pt(g_warp0), BG, 16,
                                 FLOOR)
    for res in (_np(got), want):
        assert not np.any(res[0, :, 0])                 # below the floor
        assert not np.any(res[0, :6, sat_slot])         # dL/dα masked
        assert np.all(res[0, 6:10, sat_slot] != 0.0)    # r, g, b, depth
        assert not np.any(res[0, 10])                   # the live row
        assert np.all(res[0, :10, 1] != 0.0)
    np.testing.assert_array_equal(_np(got0)[0, :, 1], _np(got)[0, :, 1])


def test_plain_blend_bwd_matches_autograd():
    a, origin, g = _blend_inputs(5, 48, 8, seed=7)
    at = torch.from_numpy(a).requires_grad_(True)
    out = PG.gs_blend_plain(at, torch.from_numpy(origin), BG, 8, FLOOR)
    (grad,) = torch.autograd.grad(out, at, _pt(g))
    got = PG.gs_blend_bwd_plain(at.detach(), *_pt((origin,) + g), BG, 8,
                                FLOOR)
    for r in range(11):
        _rel_close(got[:, r], grad[:, r], 1e-5, msg=f"row {r}")


def test_blend_function_routes_plain_on_cpu():
    a, origin, g = _blend_inputs(3, 32, 8, seed=2)
    at = torch.from_numpy(a).requires_grad_(True)
    out = PG.gs_blend(at, torch.from_numpy(origin), BG, 8)
    for o, w in zip(out, PG.gs_blend_plain(*_pt((a, origin)), BG, 8, FLOOR)):
        assert torch.equal(o, w)
    torch.autograd.backward(out, _pt(g))
    assert torch.equal(at.grad, PG.gs_blend_bwd_plain(
        *_pt((a, origin) + g), BG, 8, FLOOR))
    # an unused output's gradient is taken as zero
    (ga,) = torch.autograd.grad(PG.gs_blend(at, torch.from_numpy(origin),
                                            BG, 8)[1].sum(), at)
    assert torch.isfinite(ga).all() and float(ga.abs().sum()) > 0


# ------------------------------------------------ the whole tiled rasterizer
SIZES = {"square": ((48, 48), (24.0, 24.0)), "odd": ((50, 70), (35.0, 25.0))}
_JAX_CACHE = {}


def _tiled_case(size):
    hw, (cx, cy) = SIZES[size]
    scene = _scene(600, 5, scale=0.06)
    w2c, intr = _camera(cx=cx, cy=cy)
    gt = np.random.default_rng(9).uniform(size=hw + (3,)).astype(F32)
    kw = dict(tile_capacity=64, tiles_per_gaussian=16,
              bg_color=(0.1, 0.2, 0.3))
    return hw, scene, w2c, intr, gt, kw


def _loss(out, gt, lib):
    """tests/test_gaussian_tiled.py:233's loss."""
    mean = jnp.mean if lib is jnp else torch.mean
    return (mean((out["rgb"] - gt) ** 2) + 0.1 * mean(out["alpha"])
            + 0.01 * mean(out["depth"]))


def _jax_tiled(size):
    if size not in _JAX_CACHE:
        hw, scene, w2c, intr, gt, kw = _tiled_case(size)
        cam = _jt((w2c, intr))

        def loss(*p):
            out = JG.rasterize_gaussians_tiled(*p, *cam, hw, **kw)
            return _loss(out, jnp.asarray(gt), jnp), out

        (_, out), grads = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1, 2, 3, 4), has_aux=True))(*_jt(scene))
        _JAX_CACHE[size] = ({k: _np(v) for k, v in out.items()},
                            [_np(g) for g in grads])
    return _JAX_CACHE[size]


@pytest.mark.parametrize("size", sorted(SIZES))
@pytest.mark.parametrize("backend", ["pallas"])
def test_tiled_rasterizer_matches_jax(backend, size):
    hw, scene, w2c, intr, gt, kw = _tiled_case(size)
    want, want_g = _jax_tiled(size)
    params = _pt(scene, grad=True)
    out = PG.rasterize_gaussians_tiled(*params, *_pt((w2c, intr)), hw,
                                       blend_backend=backend, **kw)
    assert out["rgb"].shape == hw + (3,)
    assert int(out["n_dropped_pairs"]) == int(want["n_dropped_pairs"])
    for k in ("rgb", "alpha", "depth"):
        _close(out[k], want[k], atol=2e-5, msg=k)
    _loss(out, torch.from_numpy(gt), torch).backward()
    for name, p, g in zip(("means", "scales", "quats", "opac", "cols"),
                          params, want_g):
        assert float(np.abs(g).max()) > 0, name
        _rel_close(p.grad, g, 5e-5, msg=name)


# ------------------------------------------------------ render equations
def _re_inputs(n=12, seed=0):
    r = np.random.default_rng(seed)
    normals = r.normal(size=(n, 3))
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    view = normals + 0.5 * r.normal(size=(n, 3))
    view /= np.linalg.norm(view, axis=-1, keepdims=True)
    return dict(
        base_color=r.uniform(0.1, 0.9, (n, 3)), roughness=r.uniform(
            0.2, 0.9, n), metallic=r.uniform(0, 1, n), normals=normals,
        viewdirs=view, incidents_shs=0.3 * r.normal(size=(n, 9, 3)),
        direct_shs=0.3 * r.normal(size=(16, 3)),
        visibility_shs=0.3 * r.normal(size=(n, 4)))


def test_render_equation_r3dg_matches_jax():
    inp = {k: v.astype(F32) for k, v in _re_inputs().items()}
    jin = {k: jnp.asarray(v) for k, v in inp.items()}
    want = jax.jit(lambda d: JG.render_equation_r3dg(**d))(jin)
    tin = {k: torch.from_numpy(v).requires_grad_(True)
           for k, v in inp.items()}
    got = PG.render_equation_r3dg(**tin)
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k], atol=1e-5 * float(np.abs(_np(want[k])).max())
               + 1e-7, msg=k)
    grads_j = jax.jit(jax.grad(lambda d: jnp.sum(
        JG.render_equation_r3dg(**d)["pbr"] ** 2)))(jin)
    torch.sum(got["pbr"] ** 2).backward()
    for k, t in tin.items():
        _rel_close(t.grad, grads_j[k], 1e-4, msg=k)


def test_render_equation_matches_jax():
    r = np.random.default_rng(1)
    inp = _re_inputs(seed=1)
    args = dict(base_color=inp["base_color"], roughness=inp["roughness"],
                normals=inp["normals"], view_dirs=inp["viewdirs"],
                light_dirs=r.normal(size=(12, 3)),
                light_rgb=r.uniform(0.5, 1.5, (12, 3)))
    args = {k: v.astype(F32) for k, v in args.items()}
    jin = {k: jnp.asarray(v) for k, v in args.items()}
    want = jax.jit(lambda d: JG.render_equation(**d))(jin)
    tin = {k: torch.from_numpy(v).requires_grad_(True)
           for k, v in args.items()}
    got = PG.render_equation(**tin)
    _close(got, want, atol=1e-5 * float(np.abs(_np(want)).max()))
    gj = jax.jit(jax.grad(lambda d: jnp.sum(JG.render_equation(**d) ** 2)))(
        jin)
    torch.sum(got ** 2).backward()
    for k, t in tin.items():
        _rel_close(t.grad, gj[k], 1e-4, msg=k)


# ------------------------------------------- the bridge and one Adam step
def _bench_params(n, seed):
    """bench_render.py:338-347's parameter names and distributions."""
    r = np.random.default_rng(seed)
    q = r.normal(size=(n, 4))
    return {"means": r.uniform(-1, 1, (n, 3)),
            "scales": r.uniform(0.002, 0.02, (n, 3)) * 5.0,
            "quats": q / np.linalg.norm(q, axis=-1, keepdims=True),
            "opac": r.uniform(0.3, 0.9, (n, 1)),
            "cols": r.uniform(0, 1, (n, 3))}


def test_bridge_round_trip():
    params = {k: v.astype(F32) for k, v in _bench_params(50, 0).items()}
    got = bridge.gaussians_from_jax(params, device="cpu")
    assert list(got) == list(params)
    for k, t in got.items():
        assert t.dtype == torch.float32 and t.is_leaf and t.requires_grad
        assert np.array_equal(_np(t), params[k])
    back = bridge.to_jax_paths(got)
    assert all(np.array_equal(back[k], params[k]) for k in params)
    with pytest.raises(ValueError, match="float64"):
        bridge.gaussians_from_jax({"means": np.zeros((2, 3))}, device="cpu")
    with pytest.raises(KeyError):
        bridge.gaussians_from_jax({"mean": params["means"]}, device="cpu")


def test_adam_step_matches_optax():
    """main_train_gaussian's step (MSE to a target, quats normalized in the
    loss, Adam(1e-3)) at a small size, from bridged parameters."""
    params = {k: v.astype(F32) for k, v in _bench_params(400, 1).items()}
    w2c, intr = _camera(f=60.0, cx=20.0, cy=20.0)
    hw = (40, 40)
    gt = np.random.default_rng(3).uniform(size=hw + (3,)).astype(F32)
    kw = dict(tile_capacity=64)

    def loss_j(p):
        out = JG.rasterize_gaussians_tiled(
            p["means"], p["scales"],
            p["quats"] / jnp.linalg.norm(p["quats"], axis=-1, keepdims=True),
            p["opac"], p["cols"], *_jt((w2c, intr)), hw, **kw)
        return jnp.mean((out["rgb"] - gt) ** 2)

    pj = {k: jnp.asarray(v) for k, v in params.items()}
    opt = optax.adam(1e-3)
    loss_jv, g = jax.jit(jax.value_and_grad(loss_j))(pj)
    upd, _ = opt.update(g, opt.init(pj))
    want = optax.apply_updates(pj, upd)

    pt = bridge.gaussians_from_jax(params, device="cpu")
    adam = torch.optim.Adam(pt.values(), lr=1e-3)
    out = PG.rasterize_gaussians_tiled(
        pt["means"], pt["scales"],
        pt["quats"] / torch.linalg.norm(pt["quats"], dim=-1, keepdim=True),
        pt["opac"], pt["cols"], *_pt((w2c, intr)), hw,
        blend_backend="pallas", **kw)
    loss = torch.mean((out["rgb"] - torch.from_numpy(gt)) ** 2)
    loss.backward()
    adam.step()
    assert abs(float(loss.detach()) - float(loss_jv)) <= 1e-6 * float(loss_jv)
    for k, t in pt.items():
        # a first Adam step moves each entry by ~lr·sign(g); entries whose
        # gradient is ~0 may move less in either
        _close(t, want[k], atol=2e-5, msg=k)
