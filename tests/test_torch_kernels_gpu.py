"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Marked `gpu`: here (no card) every test skips. On a machine with a card,
whose Python has no JAX, run without the suite's conftest:

    python -m pytest tests/test_torch_kernels_gpu.py -m gpu --noconftest

Whether a card is present is decided inside the `cuda` fixture, never at
import time. Tolerances: B1 and B6 sum 8 weighted corners in another order
(1e-5 relative to the output scale), and their want_g outputs are copies
(exact); B3 and B8 sum over corners, features and levels and scale by
res-2 (1e-4); the table gradients of B2, B4, B7 and B9 are sums by
atomics, in an order that changes from run to run (1e-5 relative to the
largest entry), their dL/dx and dL/dg_up scale by res-2 (1e-4); B5 is a
copy (exact). The F=2 kernels run on two metas: Dense and Hash levels, and
eight levels (the most they take). The F=4 cell permuto kernels (B14–B16)
run on the dynamic NeuS's 4D meta and a small 3D one: B14 sums d+1
weighted vertices in another order (1e-5); B15's table gradient is a sum
by atomics (1e-5 relative to the largest entry), its dL/dx and B16 sum
through the elevation Jacobian and the lattice scale (1e-4). The F=2 cell
permuto kernels (B10–B13) run on the dynamic NeuS field's default 4D meta
(five hashed levels) and the 3D bench lattice (a dense level of 1985
rows, seven hashed), with the same tolerances as their F=4 counterparts.
"""

import numpy as np
import pytest
import torch

from nr3d_lib_tpu_torch.ops import _build
from nr3d_lib_tpu_torch.ops import gather1d as G
from nr3d_lib_tpu_torch.ops import lotd_brick as B
from nr3d_lib_tpu_torch.ops import lotd_brick4 as B4
from nr3d_lib_tpu_torch.ops import permuto_cell as PC
from nr3d_lib_tpu_torch.ops import permuto_cell4 as P4

pytestmark = pytest.mark.gpu

META_ARGS = ([16, 64], ["Dense", "Hash"], 4096)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dev, n: int, seed: int = 0):
    meta = B4.make_brick4_meta(*META_ARGS)
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32)
    x[:64] = ((rng.integers(0, 62, (64, 3)) + 0.5) / 62).astype(np.float32)
    x[64:66] = [[0, 0, 0], [1, 1, 1]]
    table = rng.uniform(-0.1, 0.1, (meta.total_rows, 256)).astype(np.float32)
    return meta, torch.from_numpy(x).to(dev), torch.from_numpy(table).to(dev)


@pytest.mark.parametrize("n", [1, 255, 100_000])
def test_brick4_encode_kernel_matches_plain(cuda, n):
    meta, x, table = _inputs(cuda, max(n, 66))
    x = x[:n]
    before = _build.LAUNCHES["brick4_fwd"]
    with torch.no_grad():
        y = B4.brick4_encode(x, table, meta)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["brick4_fwd"] == before + 1
    y_p = B4.brick4_encode_xla(x, table, meta)
    torch.testing.assert_close(y, y_p, rtol=0,
                               atol=1e-5 * float(y_p.abs().max()) + 1e-7)


@pytest.mark.parametrize("n", [1, 100_000])
def test_brick4_nablas_kernel_matches_plain(cuda, n):
    meta, x, table = _inputs(cuda, max(n, 66), seed=1)
    x = x[:n]
    g = torch.randn(n, 8, device=cuda)
    before = _build.LAUNCHES["brick4_dydx"]
    with torch.no_grad():
        dx = B4.brick4_nablas(g, x, table, meta)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["brick4_dydx"] == before + 1
    dx_p = B4.brick4_nablas_xla(g, x, table, meta)
    torch.testing.assert_close(dx, dx_p, rtol=0,
                               atol=1e-4 * float(dx_p.abs().max()) + 1e-6)


def test_gather1d_kernel_matches_plain(cuda):
    rng = np.random.default_rng(2)
    values = torch.from_numpy(rng.standard_normal((4096, 64))
                              .astype(np.float32)).to(cuda)
    row = torch.from_numpy(rng.integers(-3, 4100, (393_216,))
                           .astype(np.int32)).to(cuda)
    lane = torch.from_numpy(rng.integers(-2, 66, (393_216,))
                            .astype(np.int32)).to(cuda)
    before = _build.LAUNCHES["gather1d"]
    out = G.gather_rows_lanes(values, row, lane)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["gather1d"] == before + 1
    torch.testing.assert_close(out, G.gather_rows_lanes_plain(values, row,
                                                              lane),
                               rtol=0, atol=0)


def _close(got, want, rel):
    torch.testing.assert_close(got, want, rtol=0,
                               atol=rel * float(want.abs().max()) + 1e-7)


@pytest.mark.parametrize("n", [1, 255, 100_000])
def test_brick4_want_g_kernel_matches_plain(cuda, n):
    meta, x, table = _inputs(cuda, max(n, 66), seed=2)
    x = x[:n]
    before = _build.LAUNCHES["brick4_fwd_g"]
    y, words = B4._fwd_cuda(x, B4.pack_table4(table), meta, want_g=True)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["brick4_fwd_g"] == before + 1
    _close(y, B4.brick4_encode_xla(x, table, meta), 1e-5)
    assert torch.equal(words, B4.brick4_corner_words_xla(x, table, meta))


@pytest.mark.parametrize("n", [1, 255, 100_000])
@pytest.mark.parametrize("form", ["no_dx", "dx_words", "dx_table"])
def test_brick4_bwd_kernel_matches_plain(cuda, n, form):
    meta, x, table = _inputs(cuda, max(n, 66), seed=3)
    x = x[:n]
    g = torch.randn(n, 8, device=cuda)
    packed = B4.pack_table4(table)
    kw = {}
    if form == "dx_words":
        kw["words"] = B4._fwd_cuda(x, packed, meta, want_g=True)[1]
    elif form == "dx_table":
        kw["packed"] = packed
    before = _build.LAUNCHES["brick4_bwd"]
    dx, dtab = B4._bwd_cuda(x, g, meta, need_dx=form != "no_dx", **kw)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["brick4_bwd"] == before + 1
    dx_p, dtab_p = B4.brick4_encode_bwd_xla(x, table, g, meta,
                                            form != "no_dx")
    _close(dtab, dtab_p, 1e-5)
    if form == "no_dx":
        assert dx is None
    else:
        _close(dx, dx_p, 1e-4)


@pytest.mark.parametrize("n", [1, 255, 100_000])
def test_brick4_bwd2_kernel_matches_plain(cuda, n):
    meta, x, table = _inputs(cuda, max(n, 66), seed=4)
    x = x[:n]
    g_up, gg = torch.randn(n, 8, device=cuda), torch.randn(n, 3, device=cuda)
    before = _build.LAUNCHES["brick4_bwd2"]
    dg, dx, dtab = B4._bwd2_cuda(g_up, x, B4.pack_table4(table), gg, meta)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["brick4_bwd2"] == before + 1
    dg_p, dx_p, dtab_p = B4.brick4_nablas_bwd_xla(g_up, x, table, gg, meta)
    _close(dg, dg_p, 1e-4)
    _close(dx, dx_p, 1e-4)
    _close(dtab, dtab_p, 1e-5)


def test_cuda_gradients_match_cpu_route(cuda):
    """The CUDA route's autograd (B1/B2, B3/B4) against the CPU route's
    (plain versions, torch autograd) on the same inputs."""
    meta, x, table = _inputs(cuda, 4096, seed=5)
    g, gg = torch.randn(4096, 8, device=cuda), torch.randn(4096, 3,
                                                            device=cuda)
    gu = torch.randn(4096, 8, device=cuda)
    grads = []
    for dev in (cuda, torch.device("cpu")):
        xs, ts, gs = (t.detach().to(dev).requires_grad_(True)
                      for t in (x, table, gu))
        loss = (B4.brick4_encode(xs, ts, meta) * g.to(dev)).sum() + \
            (B4.brick4_nablas(gs, xs, ts, meta) * gg.to(dev)).sum()
        grads.append([t.cpu() for t in torch.autograd.grad(loss,
                                                           (xs, ts, gs))])
    for a, b, rel in zip(*grads, (1e-4, 1e-5, 1e-4)):
        _close(a, b, rel)


def test_train_step_goes_through_the_kernels(cuda):
    from nr3d_lib_tpu_torch.models.loss.regularization import eikonal_loss

    model = _small_model()
    o, d = _small_rays(cuda)
    opt = torch.optim.Adam(model.parameters(), lr=5e-3)
    gen = torch.Generator(device=cuda).manual_seed(0)
    with torch.no_grad():
        model.populate()
    for it in (15, 16):                      # 16: the occupancy update
        _build.LAUNCHES.clear()
        model.training_before_per_step(it, gen)
        opt.zero_grad()
        rendered, vb = model.ray_query(model.ray_test(o, d), generator=gen)
        loss = torch.mean((rendered["rgb_volume"] - d.abs()) ** 2) + \
            0.1 * eikonal_loss(vb["nablas_packed"], vb["ridx"] < o.shape[0])
        loss.backward()
        opt.step()
        torch.cuda.synchronize()
        assert dict(_build.LAUNCHES) == {
            "brick4_fwd": 6 + (it == 16), "brick4_bwd": 1, "brick4_dydx": 1,
            "brick4_bwd2": 1, "gather1d": 1}, (it, dict(_build.LAUNCHES))
        assert torch.isfinite(loss)
        for p in model.parameters():
            assert p.grad is not None and torch.isfinite(p.grad).all()


def _small_model(n_feats: int = 4):
    from nr3d_lib_tpu_torch.models.model_base import LoTDNeuSModel

    lotd = {"lod_res": [16, 64], "lod_n_feats": 4,
            "lod_types": ["Dense", "Hash"]} if n_feats == 4 else \
        {"lod_res": [16, 32, 64, 128], "lod_n_feats": 2,
         "lod_types": ["Dense", "Dense", "Hash", "Hash"]}
    enc = {"lotd_cfg": lotd, "backend": "brick"}
    return LoTDNeuSModel(
        field_cfg={"surface_cfg": {"encoding_cfg": enc,
                                   "decoder_cfg": {"D": 1, "W": 64}},
                   "radiance_cfg": {"D": 2, "W": 64}},
        accel_cfg={"resolution": 32, "max_steps_per_ray": 48,
                   "step_size": 2.0 / 48},
        ray_query_cfg={"query_mode": "march_occ_multi_upsample_compressed",
                       "march_budget_factor": 0.5})


def _small_rays(dev):
    rng = np.random.default_rng(3)
    o = rng.normal(size=(256, 3))
    o = (o / np.linalg.norm(o, axis=-1, keepdims=True) * 2.0)
    d = -o / np.linalg.norm(o, axis=-1, keepdims=True)
    return (torch.from_numpy(a.astype(np.float32)).to(dev) for a in (o, d))


def test_render_goes_through_the_kernels(cuda):
    model = _small_model()
    assert model.device.type == "cuda"
    o, d = _small_rays(cuda)
    with torch.no_grad():
        model.populate()
        _build.LAUNCHES.clear()
        rendered, _ = model.ray_query(model.ray_test(o, d))
    torch.cuda.synchronize()
    assert dict(_build.LAUNCHES) == {"brick4_fwd": 6, "brick4_dydx": 1,
                                     "gather1d": 1}
    for v in rendered.values():
        assert torch.isfinite(v).all()


# ------------------------------------------------------------ F=2 (B6-B9)
F2_METAS = {"dense_hash": ([16, 32, 64, 128], ["Dense", "Dense", "Hash",
                                               "Hash"], 4096),
            "eight_levels": ([8, 12, 16, 24, 32, 48, 64, 96],
                             ["Dense"] * 3 + ["Hash"] * 5, 256)}
F2_CASES = [(m, n) for m in sorted(F2_METAS) for n in (1, 255, 100_000)]


def _f2_inputs(dev, meta_name: str, n: int, seed: int):
    lod_res, types, rows = F2_METAS[meta_name]
    meta = B.make_brick_meta(lod_res, types, rows)
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, 1.0, (max(n, 66), 3)).astype(np.float32)
    r = lod_res[1]
    x[:64] = ((rng.integers(0, r - 2, (64, 3)) + 0.5) / (r - 2)).astype(
        np.float32)
    x[64:66] = [[0, 0, 0], [1, 1, 1]]
    table = rng.uniform(-0.1, 0.1, (meta.total_rows, 128)).astype(np.float32)
    gen = torch.Generator(device=dev).manual_seed(seed)
    L = meta.n_levels
    g = torch.randn(n, 2 * L, device=dev, generator=gen)
    gg = torch.randn(n, 3, device=dev, generator=gen)
    return (meta, torch.from_numpy(x[:n]).to(dev),
            torch.from_numpy(table).to(dev), g, gg)


@pytest.mark.parametrize("meta_name,n", F2_CASES)
@pytest.mark.parametrize("want_g", [False, True])
def test_brick_fwd_kernel_matches_plain(cuda, meta_name, n, want_g):
    meta, x, table, _, _ = _f2_inputs(cuda, meta_name, n, 10)
    key = "brick_fwd_g" if want_g else "brick_fwd"
    before = _build.LAUNCHES[key]
    out = B._fwd_cuda(x, table, meta, want_g=want_g)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[key] == before + 1
    y = out[0] if want_g else out
    _close(y, B.brick_encode_xla(x, table, meta), 1e-5)
    if want_g:
        assert torch.equal(out[1], B.brick_corner_values_xla(x, table, meta))
    with torch.no_grad():                   # the wrapper's CUDA route
        _close(B.brick_encode(x, table, meta), y, 0.0)


@pytest.mark.parametrize("meta_name,n", F2_CASES)
@pytest.mark.parametrize("form", ["no_dx", "dx_corners", "dx_table"])
def test_brick_bwd_kernel_matches_plain(cuda, meta_name, n, form):
    meta, x, table, g, _ = _f2_inputs(cuda, meta_name, n, 11)
    kw = {}
    if form == "dx_corners":
        kw["corners"] = B._fwd_cuda(x, table, meta, want_g=True)[1]
    elif form == "dx_table":
        kw["table"] = table
    before = _build.LAUNCHES["brick_bwd"]
    dx, dtab = B._bwd_cuda(x, g, meta, need_dx=form != "no_dx", **kw)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["brick_bwd"] == before + 1
    dx_p, dtab_p = B.brick_encode_bwd_xla(x, table, g, meta, form != "no_dx")
    _close(dtab, dtab_p, 1e-5)
    if form == "no_dx":
        assert dx is None
    else:
        _close(dx, dx_p, 1e-4)


@pytest.mark.parametrize("meta_name,n", F2_CASES)
def test_brick_dydx_kernel_matches_plain(cuda, meta_name, n):
    meta, x, table, g, _ = _f2_inputs(cuda, meta_name, n, 12)
    before = _build.LAUNCHES["brick_dydx"]
    with torch.no_grad():
        dx = B.brick_nablas(g, x, table, meta)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["brick_dydx"] == before + 1
    _close(dx, B.brick_nablas_xla(g, x, table, meta), 1e-4)


@pytest.mark.parametrize("meta_name,n", F2_CASES)
def test_brick_bwd2_kernel_matches_plain(cuda, meta_name, n):
    meta, x, table, g, gg = _f2_inputs(cuda, meta_name, n, 13)
    before = _build.LAUNCHES["brick_bwd2"]
    dg, dx, dtab = B._bwd2_cuda(g, x, table, gg, meta)
    _, no_dx, dtab2 = B._bwd2_cuda(g, x, table, gg, meta, need_dx=False)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["brick_bwd2"] == before + 2 and no_dx is None
    dg_p, dx_p, dtab_p = B.brick_nablas_bwd_xla(g, x, table, gg, meta)
    _close(dg, dg_p, 1e-4)
    _close(dx, dx_p, 1e-4)
    _close(dtab, dtab_p, 1e-5)
    _close(dtab2, dtab_p, 1e-5)


def test_brick_cuda_gradients_match_cpu_route(cuda):
    """The CUDA route's autograd (B6/B7, B8/B9) against the CPU route's
    (plain versions, torch autograd) on the same inputs; and the frozen-x
    encode's table gradient."""
    meta, x, table, g, gg = _f2_inputs(cuda, "dense_hash", 4096, 14)
    gu = torch.randn_like(g)
    grads = []
    for dev in (cuda, torch.device("cpu")):
        xs, ts, gs = (t.detach().to(dev).requires_grad_(True)
                      for t in (x, table, gu))
        loss = (B.brick_encode(xs, ts, meta) * g.to(dev)).sum() + \
            (B.brick_nablas(gs, xs, ts, meta) * gg.to(dev)).sum() + \
            (B.brick_encode_frozen_x(xs, ts, meta) * g.to(dev)).sum()
        grads.append([t.cpu() for t in torch.autograd.grad(loss,
                                                           (xs, ts, gs))])
    for a, b, rel in zip(*grads, (1e-4, 1e-5, 1e-4)):
        _close(a, b, rel)


def _step_launches(model, o, d, gen, it):
    from nr3d_lib_tpu_torch.models.loss.regularization import eikonal_loss

    _build.LAUNCHES.clear()
    model.training_before_per_step(it, gen)
    rendered, vb = model.ray_query(model.ray_test(o, d), generator=gen)
    loss = torch.mean((rendered["rgb_volume"] - d.abs()) ** 2) + \
        0.1 * eikonal_loss(vb["nablas_packed"], vb["ridx"] < o.shape[0])
    loss.backward()
    torch.cuda.synchronize()
    assert torch.isfinite(loss)
    return dict(_build.LAUNCHES)


def test_f2_step_and_render_go_through_the_kernels(cuda):
    model = _small_model(n_feats=2)
    o, d = _small_rays(cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)
    with torch.no_grad():
        model.populate()
        _build.LAUNCHES.clear()
        rendered, _ = model.ray_query(model.ray_test(o, d))
    torch.cuda.synchronize()
    assert dict(_build.LAUNCHES) == {"brick_fwd": 6, "brick_dydx": 1,
                                     "gather1d": 1}
    for it in (15, 16):                      # 16: the occupancy update
        assert _step_launches(model, o, d, gen, it) == {
            "brick_fwd": 6 + (it == 16), "brick_bwd": 1, "brick_dydx": 1,
            "brick_bwd2": 1, "gather1d": 1}, it
    _build.LAUNCHES.clear()
    x = (o[:, None] * 0.25 + d[:, None] * 0.5).reshape(-1, 3)
    xr = x.clone().requires_grad_(True)
    torch.autograd.grad(model.forward_sdf(xr)["sdf"].sum(), xr)
    torch.cuda.synchronize()
    assert dict(_build.LAUNCHES) == {"brick_fwd_g": 1, "brick_bwd": 1}


@pytest.mark.parametrize("mode", ["march_occ", "march_occ_compressed"])
def test_nerf_render_goes_through_the_kernels(cuda, mode):
    from nr3d_lib_tpu_torch.models.model_base import LoTDNeRFModel

    model = LoTDNeRFModel(
        field_cfg={"encoding_cfg": {"lotd_cfg": {
            "lod_res": [16, 32, 64, 128], "lod_n_feats": 2,
            "lod_types": ["Dense", "Dense", "Hash", "Hash"]},
            "backend": "brick"},
            "density_decoder_cfg": {"D": 1, "W": 64},
            "radiance_cfg": {"D": 2, "W": 64}},
        accel_cfg={"resolution": 32, "max_steps_per_ray": 48,
                   "step_size": 2.0 / 48},
        ray_query_cfg={"query_mode": mode})
    o, d = _small_rays(cuda)
    with torch.no_grad():
        model.populate()
        _build.LAUNCHES.clear()
        rendered, _ = model.ray_query(model.ray_test(o, d))
    torch.cuda.synchronize()
    assert dict(_build.LAUNCHES) == {"brick_fwd": 1, "gather1d": 1}
    for v in rendered.values():
        assert torch.isfinite(v).all()
    # a train step of the density path: frozen x, so B7 without dL/dx
    _build.LAUNCHES.clear()
    rendered, _ = model.ray_query(model.ray_test(o, d))
    rendered["rgb_volume"].square().mean().backward()
    torch.cuda.synchronize()
    assert dict(_build.LAUNCHES) == {"brick_fwd": 1, "brick_bwd": 1,
                                     "gather1d": 1}
    assert model.field.encoding.flattened_params.grad.abs().max() > 0


# ---------------------------------------------- F=4 cell permuto (B14-B16)
P4_METAS = {"yaml4d": (4, [4.0, 11.0, 32.0, 90.0], 4096),
            "small3d": (3, [2.0, 8.0, 24.0], 64)}
P4_CASES = [(m, n) for m in sorted(P4_METAS) for n in (1, 255, 100_000)]


def _p4_inputs(dev, meta_name: str, n: int, seed: int):
    d, res, rows = P4_METAS[meta_name]
    meta = P4.make_permuto_cell4_meta(d, res, rows)
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, 1.0, (max(n, 300), d)).astype(np.float32)
    x[:100] = np.round(x[:100] * 8.0) / 8.0           # lattice ties
    x[100:120] = 0.5
    x[120:200] = x[120:200, :1]
    x[200], x[201] = 0.0, 1.0
    x = x[rng.permutation(len(x))][:n]
    table = rng.uniform(-0.1, 0.1, (meta.total_rows, 256)).astype(np.float32)
    gen = torch.Generator(device=dev).manual_seed(seed)
    g = torch.randn(n, 4 * meta.n_levels, device=dev, generator=gen)
    return (meta, torch.from_numpy(x).to(dev), torch.from_numpy(table).to(dev),
            g)


@pytest.mark.parametrize("meta_name,n", P4_CASES)
def test_permuto4_fwd_kernel_matches_plain(cuda, meta_name, n):
    meta, x, table, _ = _p4_inputs(cuda, meta_name, n, 20)
    before = _build.LAUNCHES["permuto4_fwd"]
    with torch.no_grad():
        y = P4.permuto_cell4_encode(x, table, meta)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["permuto4_fwd"] == before + 1
    _close(y, P4.permuto_cell4_encode_xla(x, table, meta), 1e-5)


@pytest.mark.parametrize("meta_name,n", P4_CASES)
@pytest.mark.parametrize("need_dx", [False, True])
def test_permuto4_bwd_kernel_matches_plain(cuda, meta_name, n, need_dx):
    meta, x, table, g = _p4_inputs(cuda, meta_name, n, 21)
    before = _build.LAUNCHES["permuto4_bwd"]
    dx, dtab = P4._bwd_cuda(x, g, meta, need_dx=need_dx,
                            packed=P4.pack_table4(table))
    torch.cuda.synchronize()
    assert _build.LAUNCHES["permuto4_bwd"] == before + 1
    dx_p, dtab_p = P4.permuto_cell4_encode_bwd_xla(x, table, g, meta,
                                                   need_dx)
    _close(dtab, dtab_p, 1e-5)
    if need_dx:
        _close(dx, dx_p, 1e-4)
    else:
        assert dx is None


@pytest.mark.parametrize("meta_name,n", P4_CASES)
def test_permuto4_dydx_kernel_matches_plain(cuda, meta_name, n):
    meta, x, table, g = _p4_inputs(cuda, meta_name, n, 22)
    before = _build.LAUNCHES["permuto4_dydx"]
    with torch.no_grad():
        dx = P4.permuto_cell4_nablas(g, x, table, meta)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["permuto4_dydx"] == before + 1
    _close(dx, P4.permuto_cell4_nablas_xla(g, x, table, meta), 1e-4)


@pytest.mark.parametrize("meta_name", sorted(P4_METAS))
def test_permuto4_autograd_matches_cpu_route(cuda, meta_name):
    """The CUDA route's autograd (B14/B15 with dL/dx, B16 with the plain
    vjp as its backward) against the CPU route's on the same inputs."""
    meta, x, table, gu = _p4_inputs(cuda, meta_name, 4096, 23)
    gen = torch.Generator(device=cuda).manual_seed(24)
    g = torch.randn(gu.shape, device=cuda, generator=gen)
    gg = torch.randn(x.shape, device=cuda, generator=gen)
    grads = []
    for dev in (cuda, torch.device("cpu")):
        _build.LAUNCHES.clear()
        xs, ts, gs = (t.detach().to(dev).requires_grad_(True)
                      for t in (x, table, gu))
        loss = (P4.permuto_cell4_encode(xs, ts, meta) * g.to(dev)).sum() + \
            (P4.permuto_cell4_nablas(gs, xs, ts, meta) * gg.to(dev)).sum()
        grads.append([t.cpu() for t in torch.autograd.grad(loss,
                                                           (xs, ts, gs))])
        launches = dict(_build.LAUNCHES)
        assert launches == ({"permuto4_fwd": 1, "permuto4_bwd": 1,
                             "permuto4_dydx": 1} if dev == cuda else {})
    for a, b, rel in zip(*grads, (1e-4, 1e-5, 1e-4)):
        _close(a, b, rel)


def _dynamic_model():
    from nr3d_lib_tpu_torch.models.model_families import \
        DynamicPermutoNeuSModel

    return DynamicPermutoNeuSModel(
        field_cfg={"surface_cfg": {
            "permuto_cfg": {"res_list": [4.0, 11.0, 32.0, 90.0],
                            "backend": "cell", "n_feats": 4,
                            "hashmap_rows": 4096},
            "decoder_cfg": {"D": 1, "W": 64}},
            "radiance_cfg": {"D": 2, "W": 64}},
        n_time_keys=8, ray_query_cfg={"n_coarse": 32, "n_importance": 8})


def test_dynamic_step_and_render_go_through_the_kernels(cuda):
    from nr3d_lib_tpu_torch.models.loss.regularization import eikonal_loss

    model = _dynamic_model()
    o, d = _small_rays(cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)
    ts = torch.rand(o.shape[0], device=cuda, generator=gen) * 2.0 - 1.0
    model.populate(gen)
    rt = model.ray_test(o, d)
    rt["ts"] = ts
    with torch.no_grad():
        _build.LAUNCHES.clear()
        rendered, _ = model.ray_query(rt)
    torch.cuda.synchronize()
    assert dict(_build.LAUNCHES) == {"permuto4_fwd": 4, "permuto4_dydx": 1}
    for v in rendered.values():
        assert torch.isfinite(v).all()
    opt = torch.optim.Adam(model.parameters(), lr=5e-3)
    for it in (15, 16):                      # 16: the occupancy update
        _build.LAUNCHES.clear()
        model.training_before_per_step(it, gen)
        opt.zero_grad()
        rendered, vb = model.ray_query(rt, generator=gen)
        loss = torch.mean((rendered["rgb_volume"] - d.abs()) ** 2) + \
            0.1 * eikonal_loss(vb["nablas"])
        loss.backward()
        opt.step()
        torch.cuda.synchronize()
        assert dict(_build.LAUNCHES) == {
            "permuto4_fwd": 4 + (it == 16), "permuto4_bwd": 1,
            "permuto4_dydx": 1}, (it, dict(_build.LAUNCHES))
        assert torch.isfinite(loss)
        for p in model.parameters():
            assert p.grad is not None and torch.isfinite(p.grad).all()


# ---------------------------------------------- F=2 cell permuto (B10-B13)
PC_METAS = {"pathd4d": (4, [8.0, 16.0, 32.0, 64.0, 128.0], 4096),
            "bench3d": (3, [16.0 * 2 ** (0.5 * i) for i in range(8)], 4096)}
PC_CASES = [(m, n) for m in sorted(PC_METAS) for n in (1, 255, 100_000)]


def _pc_inputs(dev, meta_name: str, n: int, seed: int):
    d, res, rows = PC_METAS[meta_name]
    meta = PC.make_permuto_cell_meta(d, res, rows)
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, 1.0, (max(n, 300), d)).astype(np.float32)
    x[:100] = np.round(x[:100] * 8.0) / 8.0           # lattice ties
    x[100:120] = 0.5
    x[120:200] = x[120:200, :1]
    x[200], x[201] = 0.0, 1.0
    x = x[rng.permutation(len(x))][:n]
    table = rng.uniform(-0.1, 0.1, (meta.total_rows, 128)).astype(np.float32)
    gen = torch.Generator(device=dev).manual_seed(seed)
    g = torch.randn(n, 2 * meta.n_levels, device=dev, generator=gen)
    return (meta, torch.from_numpy(x).to(dev), torch.from_numpy(table).to(dev),
            g)


@pytest.mark.parametrize("meta_name,n", PC_CASES)
def test_permuto_fwd_kernel_matches_plain(cuda, meta_name, n):
    meta, x, table, _ = _pc_inputs(cuda, meta_name, n, 30)
    before = _build.LAUNCHES["permuto_fwd"]
    with torch.no_grad():
        y = PC.permuto_cell_encode(x, table, meta)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["permuto_fwd"] == before + 1
    _close(y, PC.permuto_cell_encode_xla(x, table, meta), 1e-5)


@pytest.mark.parametrize("meta_name,n", PC_CASES)
@pytest.mark.parametrize("need_dx", [False, True])
def test_permuto_bwd_kernel_matches_plain(cuda, meta_name, n, need_dx):
    meta, x, table, g = _pc_inputs(cuda, meta_name, n, 31)
    before = _build.LAUNCHES["permuto_bwd"]
    dx, dtab = PC._bwd_cuda(x, g, meta, need_dx=need_dx, table=table)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["permuto_bwd"] == before + 1
    dx_p, dtab_p = PC.permuto_cell_encode_bwd_xla(x, table, g, meta, need_dx)
    _close(dtab, dtab_p, 1e-5)
    if need_dx:
        _close(dx, dx_p, 1e-4)
    else:
        assert dx is None


@pytest.mark.parametrize("meta_name,n", PC_CASES)
def test_permuto_dydx_kernel_matches_plain(cuda, meta_name, n):
    meta, x, table, g = _pc_inputs(cuda, meta_name, n, 32)
    before = _build.LAUNCHES["permuto_dydx"]
    with torch.no_grad():
        dx = PC.permuto_cell_nablas(g, x, table, meta)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["permuto_dydx"] == before + 1
    _close(dx, PC.permuto_cell_nablas_xla(g, x, table, meta), 1e-4)


@pytest.mark.parametrize("meta_name", sorted(PC_METAS))
@pytest.mark.parametrize("x_grad", [False, True])
def test_permuto_autograd_matches_cpu_route(cuda, meta_name, x_grad):
    """The CUDA route's autograd (B10, B11 or B12 by whether x needs its
    gradient, B13 with the plain vjp as its backward) against the CPU
    route's on the same inputs."""
    meta, x, table, gu = _pc_inputs(cuda, meta_name, 4096, 33)
    gen = torch.Generator(device=cuda).manual_seed(34)
    g = torch.randn(gu.shape, device=cuda, generator=gen)
    gg = torch.randn(x.shape, device=cuda, generator=gen)
    grads = []
    for dev in (cuda, torch.device("cpu")):
        _build.LAUNCHES.clear()
        xs, ts, gs = (t.detach().to(dev).requires_grad_(True)
                      for t in (x, table, gu))
        xe = xs if x_grad else xs.detach()
        loss = (PC.permuto_cell_encode(xe, ts, meta) * g.to(dev)).sum() + \
            (PC.permuto_cell_nablas(gs, xs, ts, meta) * gg.to(dev)).sum()
        grads.append([None if t is None else t.cpu()
                      for t in torch.autograd.grad(loss, (xs, ts, gs),
                                                   allow_unused=True)])
        launches = dict(_build.LAUNCHES)
        assert launches == ({"permuto_fwd": 1, "permuto_bwd": 1,
                             "permuto_dydx": 1} if dev == cuda else {})
    for a, b, rel in zip(*grads, (1e-4, 1e-5, 1e-4)):
        if b is None:
            assert a is None or not a.abs().any()
        else:
            _close(a, b, rel)


def _path_d_model():
    from nr3d_lib_tpu_torch.models.model_families import \
        DynamicPermutoNeuSModel

    return DynamicPermutoNeuSModel(
        field_cfg={"surface_cfg": {"permuto_cfg": {"backend": "cell"},
                                   "decoder_cfg": {"D": 1, "W": 64}},
                   "radiance_cfg": {"D": 2, "W": 64}},
        n_time_keys=8, ray_query_cfg={"n_coarse": 32, "n_importance": 8})


def test_path_d_step_and_render_go_through_the_kernels(cuda):
    from nr3d_lib_tpu_torch.models.loss.regularization import eikonal_loss

    model = _path_d_model()
    bank = model.field.implicit_surface.bank
    assert (bank.n_feats, bank.meta.total_rows) == (2, 20480)
    o, d = _small_rays(cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)
    ts = torch.rand(o.shape[0], device=cuda, generator=gen) * 2.0 - 1.0
    model.populate(gen)
    rt = model.ray_test(o, d)
    rt["ts"] = ts
    with torch.no_grad():
        _build.LAUNCHES.clear()
        rendered, _ = model.ray_query(rt)
    torch.cuda.synchronize()
    assert dict(_build.LAUNCHES) == {"permuto_fwd": 4, "permuto_dydx": 1}
    for v in rendered.values():
        assert torch.isfinite(v).all()
    opt = torch.optim.Adam(model.parameters(), lr=5e-3)
    for it in (15, 16):                      # 16: the occupancy update
        _build.LAUNCHES.clear()
        model.training_before_per_step(it, gen)
        opt.zero_grad()
        rendered, vb = model.ray_query(rt, generator=gen)
        loss = torch.mean((rendered["rgb_volume"] - d.abs()) ** 2) + \
            0.1 * eikonal_loss(vb["nablas"])
        loss.backward()
        opt.step()
        torch.cuda.synchronize()
        assert dict(_build.LAUNCHES) == {
            "permuto_fwd": 4 + (it == 16), "permuto_bwd": 1,
            "permuto_dydx": 1}, (it, dict(_build.LAUNCHES))
        assert torch.isfinite(loss)
        for p in model.parameters():
            assert p.grad is not None and torch.isfinite(p.grad).all()
