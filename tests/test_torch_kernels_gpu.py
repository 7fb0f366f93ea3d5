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
(five hashed levels), the 3D bench lattice (a dense level of 1985
rows, seven hashed) and the generative field's 5D meta (latent_dim 2),
with the same tolerances as their F=4 counterparts.
The gaussian blend (B17, B18) runs at T ∈ {1, 7, 1024} tiles, K ∈ {1, 32,
256} slots and tile ∈ {8, 16}: B17 within 1e-5 of each output's largest
entry (sums over the slots in another order), B18 within 1e-4 of each
row's largest gradient (pixel sums and suffix sums in another order,
divided by 1 − α ≥ 0.001); B18 also on tiles where whole warps take no
slot and slots lie below the α floor or saturate everywhere (the rows
its warp vote skips must be exact zeros), and at the bench scene's
attrs. B10 and B14 also run on points along rays and on the same
points permuted (the permuted rows must be the same bits), d = 2–5; so
does B15, whose dL/dx must then be the same bits, and on warps whose
points share one cell; so do B11/B12 (F=2, the same design), B9 and B4,
whose dL/dg_up and dL/dx must be the same bits in two runs and in both
orders, and B7 and B2, whose dL/dx must (L = 1-8 and 1-4); B6 too, in
both forms and at six levels as well, whose y must be the same bits in
both forms and in both orders and whose corners must be exact; B1's
want_g form at L = 1-4 likewise (its words exact); B13 at the path D
and 3D lattice metas, B16 at the F=4 metas, B8 at the F=2 ones and B3
at L = 1, 3 and 4, whose dx must be the same bits in both orders (B3's
zeros at L = 0, as B1, B2 and B4 give their empty outputs and dL/dx of
zeros there, now through the C entry: the wrappers refuse a meta with
no level, as the JAX reference does); B5 at every length mod 4, on
misaligned views and clamped indices, exactly. The backward entries of
B7, B9, B11/B12 and B15 (and B8) at a meta with no level, through their
C entries: dL/dx zeroed, the table gradient's rows untouched. The forest
forms of B6, B7, B8 and B9 (a block row offset `bidx`) against their
plain versions at random blocks, −1 included (tolerances as the
null-bidx forms'), with bidx 0 on one block bitwise the null-bidx
entries (the table gradients within the atomics' tolerance), and on a
block whose rows start past 2^25 rows of the table (the 64-bit offset);
B7's and B9's forest forms also along rays and permuted (dL/dx and
dL/dg_up the same bits) and on a warp whose lanes share one block-local
slot in four blocks (the warps' sums keep the blocks apart). The
search's shortcuts are checked over all 2^32 inputs: its division by d+1
bitwise against x / b, its modulus exactly. Two paths that launch no new
kernel: the classic permutohedral lattice (plain PyTorch) on the card
against its CPU result (keys and hash indices exact, values and first
and second order within 1e-5 of the largest entry), and the sphere
trace's fixed-count loop against its early exit (t and status bitwise).
Two model paths of the conditional and dynamic families: the EmerNeRF
render's two B5 lookups (the static grid, the any-time union of the
dynamic grids) bitwise against the plain take, two launches a render;
the d = 5 generative cell field's B10 and B13 (the nablas of its split
form) against the CPU route, 4 B10 + 1 B13 a render. The cell banks'
any-order encode (`ho=True`, plain PyTorch on the card, no launch)
against the CPU route: values within 1e-5, the input gradient and a
second-order gradient (dL/dtable of a loss on the input gradient) within
1e-4 of the largest entry. The program layer at a small size against the CPU route:
`chamfer_distance` (1e-6 relative), `extract_mesh` of a NeuS pretrained
to a sphere (the same faces, vertices within 1e-4) and `render_turntable`
(at least 99% of the pixels equal, the rest within one 8-bit level).
The ray, pack and maths layers (ROADMAP A14): `brick4_encode_frozen_x`
launches B1, then B2 without dL/dx (dL/dtable within the atomics'
tolerance of the plain version's, no gradient for x); DMTet at resolution
32 over a brick4 SDF against the CPU route given the card's SDF (masks
bitwise, triangles within 1e-5, the SDF's and the deformation's gradients
within 1e-4 relative L2); one pose-refinement step through the --w4
NeuS render pretrained to the radius-0.5 sphere (an OpenCV camera,
TransformExpSE3 ∘ TransformRT) against
the CPU route (loss within 1e-4 relative, the gradients in (w, v, θ)
within 1e-2 relative L2, B1 want_g and B2 and B4 with dL/dx launched);
`packed_sort` on the card bitwise the CPU's on keys with many ties
(stable). Infra and multi-GPU (ROADMAP A15): a small F=4 NeuS step on two
gloo ranks that share the card (`spawn`ed, the rank body in
`tests/torch_parallel_ranks.py`; the kernels built before) against one
process on the two halves with the same draws (losses within 1e-5 and
step 1's gradients within 1e-5 relative L2 — B2's atomics —, the
parameters within 1e-4; the two ranks the same bits); `loop_chunks`
over B1 the bits of one call, one launch a chunk; `instantiate` of
`examples/configs/lotd_nerf_w4.yaml` on the card (its render launches B1
and B5 and agrees with the CPU route on at least 99% of the rays within
1e-4).
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
from torch_gs_tiles import near_floor_tiles

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
            "bench3d": (3, [16.0 * 2 ** (0.5 * i) for i in range(8)], 4096),
            # the generative field's cell layout at latent_dim 2
            "gen5d": (5, [8.0, 16.0, 32.0, 64.0], 4096)}
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


# ------------------------------------------- B17 / B18: the gaussian blend
def _gs_blend_inputs(dev, n_t: int, k: int, tile: int, seed: int = 0):
    """Per-tile attrs [T, 11, K] (centres in and around the tile, σ 1–6 px,
    depths increasing along the slots, a quarter of the slots dead, every
    9th opacity 1.2 so raw α ≥ 0.999 at its centre), origins on a grid and
    upstream gradients, all from numpy."""
    r = np.random.default_rng(seed)
    origin = np.stack([(np.arange(n_t) % 32) * tile,
                       (np.arange(n_t) // 32) * tile], -1).astype(np.float32)
    a = np.zeros((n_t, 11, k), np.float32)
    a[:, 0:2] = origin[:, :, None] + r.uniform(-0.3 * tile, 1.3 * tile,
                                               (n_t, 2, k))
    sig = r.uniform(1.0, 6.0, (n_t, 2, k))
    rho = r.uniform(-0.6, 0.6, (n_t, k))
    det = sig[:, 0] ** 2 * sig[:, 1] ** 2 * (1 - rho ** 2)
    a[:, 2] = sig[:, 1] ** 2 / det
    a[:, 3] = -rho * sig[:, 0] * sig[:, 1] / det
    a[:, 4] = sig[:, 0] ** 2 / det
    a[:, 5] = r.uniform(0.3, 0.95, (n_t, k))
    a[:, 5, 1::9] = 1.2
    a[:, 6:9] = r.uniform(0, 1, (n_t, 3, k))
    a[:, 9] = np.sort(r.uniform(1.0, 5.0, (n_t, k)), -1)
    a[:, 10] = 1.0
    a[:, :, k - k // 4:] = 0.0
    p = tile * tile
    g = (r.normal(size=(n_t, p, 3)), r.normal(size=(n_t, p)),
         0.1 * r.normal(size=(n_t, p)))
    to = lambda x: torch.from_numpy(np.asarray(x, np.float32)).to(dev)  # noqa
    return to(a), to(origin), tuple(to(x) for x in g)


GS_BG, GS_FLOOR = (0.3, 0.2, 0.7), 1.0 / 255.0
GS_CASES = [(t, k, tile) for t in (1, 7, 1024) for k in (1, 32, 256)
            for tile in (8, 16)]


@pytest.mark.parametrize("n_t,k,tile", GS_CASES)
def test_gs_blend_kernel_matches_plain(cuda, n_t, k, tile):
    """B17 against `gs_blend_plain` on the card: 1e-5 of each output's
    largest entry (sums over K slots in another order; the plain version's
    cumprod is a parallel scan on the card)."""
    from nr3d_lib_tpu_torch.graphics import gaussian_splatting as GS

    a, origin, _ = _gs_blend_inputs(cuda, n_t, k, tile, seed=k + tile)
    before = _build.LAUNCHES["gs_blend"]
    with torch.no_grad():
        out = GS.gs_blend(a, origin, GS_BG, tile, GS_FLOOR)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["gs_blend"] == before + 1
    ref = GS.gs_blend_plain(a, origin, GS_BG, tile, GS_FLOOR)
    for got, want in zip(out, ref):
        assert got.shape == want.shape
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=1e-5 * float(want.abs().max()) + 1e-7)


@pytest.mark.parametrize("n_t,k,tile", GS_CASES)
def test_gs_blend_bwd_kernel_matches_plain(cuda, n_t, k, tile):
    """B18 against `gs_blend_bwd_plain` on the card: 1e-4 of each row's
    largest gradient (sums over the tile's pixels and suffix sums over the
    slots in another order, divided by 1 − α ≥ 0.001)."""
    from nr3d_lib_tpu_torch.graphics import gaussian_splatting as GS

    a, origin, g = _gs_blend_inputs(cuda, n_t, k, tile, seed=k + tile + 1)
    before = _build.LAUNCHES["gs_blend_bwd"]
    got = GS._bwd_cuda(a, origin, *g, GS_BG, tile, GS_FLOOR)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["gs_blend_bwd"] == before + 1
    want = GS.gs_blend_bwd_plain(a, origin, *g, GS_BG, tile, GS_FLOOR)
    for r in range(11):
        torch.testing.assert_close(
            got[:, r], want[:, r], rtol=0,
            atol=1e-4 * float(want[:, r].abs().max()) + 1e-9)


def test_gs_blend_autograd_matches_cpu_route(cuda):
    from nr3d_lib_tpu_torch.graphics import gaussian_splatting as GS

    a, origin, g = _gs_blend_inputs(cuda, 7, 64, 16, seed=3)
    grads = []
    for dev in (cuda, torch.device("cpu")):
        at = a.detach().to(dev).requires_grad_(True)
        out = GS.gs_blend(at, origin.to(dev), GS_BG, 16)
        torch.autograd.backward(out, tuple(x.to(dev) for x in g))
        grads.append(at.grad.cpu())
    for r in range(11):
        torch.testing.assert_close(
            grads[0][:, r], grads[1][:, r], rtol=0,
            atol=1e-4 * float(grads[1][:, r].abs().max()) + 1e-9)


def test_gs_blend_empty_and_bad_arguments(cuda):
    from nr3d_lib_tpu_torch.graphics import gaussian_splatting as GS

    a, origin, g = _gs_blend_inputs(cuda, 0, 32, 16)
    before = dict(_build.LAUNCHES)
    rgb, acc, dep = GS.gs_blend(a, origin, GS_BG, 16)
    d = GS._bwd_cuda(a, origin, *g, GS_BG, 16, GS_FLOOR)
    assert rgb.shape == (0, 256, 3) and acc.shape == dep.shape == (0, 256)
    assert d.shape == (0, 11, 32)
    assert dict(_build.LAUNCHES) == before            # nothing launched
    a, origin, _ = _gs_blend_inputs(cuda, 2, 32, 16)
    with pytest.raises(ValueError, match="tile 33"):
        GS.gs_blend(a, torch.zeros(2, 2, device=cuda), GS_BG, 33)
    with pytest.raises(ValueError, match="attrs"):
        GS.gs_blend(a[:, :10], origin, GS_BG, 16)
    with pytest.raises(ValueError, match="origin"):
        GS.gs_blend(a, origin.cpu(), GS_BG, 16)


def test_gaussian_render_and_step_go_through_the_kernels(cuda):
    """A small scene: one render (1 B17) and one train step (1 B17 + 1
    B18) on the "pallas" route, against the CPU route."""
    from nr3d_lib_tpu_torch import bridge
    from nr3d_lib_tpu_torch.graphics import gaussian_splatting as GS

    r = np.random.default_rng(0)
    n = 2000
    q = r.normal(size=(n, 4))
    params = {"means": r.uniform(-1, 1, (n, 3)),
              "scales": r.uniform(0.01, 0.05, (n, 3)),
              "quats": q / np.linalg.norm(q, axis=-1, keepdims=True),
              "opac": r.uniform(0.3, 0.9, (n, 1)),
              "cols": r.uniform(0, 1, (n, 3))}
    params = {k: v.astype(np.float32) for k, v in params.items()}
    w2c = torch.eye(4)
    w2c[2, 3] = 3.0
    intr = torch.tensor([[100.0, 0, 48], [0, 100.0, 40], [0, 0, 1]])
    hw = (80, 96)
    gt = torch.from_numpy(r.uniform(size=hw + (3,)).astype(np.float32))
    outs, grads = [], []
    for dev in (cuda, torch.device("cpu")):
        p = bridge.gaussians_from_jax(params, device=dev)

        def render():
            return GS.rasterize_gaussians_tiled(
                p["means"], p["scales"],
                p["quats"] / torch.linalg.norm(p["quats"], dim=-1,
                                               keepdim=True),
                p["opac"], p["cols"], w2c.to(dev), intr.to(dev), hw,
                tile_capacity=64, blend_backend="pallas")

        _build.LAUNCHES.clear()
        with torch.no_grad():
            out = render()
        assert dict(_build.LAUNCHES) == ({"gs_blend": 1} if dev == cuda
                                         else {})
        outs.append({k: v.cpu() for k, v in out.items()})
        _build.LAUNCHES.clear()
        loss = torch.mean((render()["rgb"] - gt.to(dev)) ** 2)
        loss.backward()
        torch.cuda.synchronize()
        assert dict(_build.LAUNCHES) == ({"gs_blend": 1, "gs_blend_bwd": 1}
                                         if dev == cuda else {})
        grads.append({k: t.grad.cpu() for k, t in p.items()})
    assert int(outs[0]["n_dropped_pairs"]) == int(outs[1]["n_dropped_pairs"])
    for k in ("rgb", "alpha", "depth"):
        torch.testing.assert_close(outs[0][k], outs[1][k], rtol=0, atol=1e-4)
    for k, g in grads[1].items():
        assert float(g.abs().max()) > 0, k
        torch.testing.assert_close(grads[0][k], g, rtol=0,
                                   atol=1e-3 * float(g.abs().max()))


# ------------------ B18: the warp vote (which warps a slot's pixels touch)
def _gs_liveness_tile(dev, tile: int, k: int, kind: str, seed: int):
    """One or two tiles whose slots differ in where they are live, against
    which B18's skip of the warps that take no slot is held.

    "mixed": slot 0 below the α floor at every pixel (opacity 0.003), slot
    1 live on the first 2·tile pixels only (σ 0.4 px at y = 1), slot 2
    saturated (opacity 1.0, σ 1000 px: raw α ≥ 0.999 at every pixel),
    then ordinary slots. "dead_warps": every slot's centre in the tile's
    top rows with σ ≤ 1 px, so the lower warps take no slot at all.
    "saturated": every third slot saturated."""
    a, origin, g = _gs_blend_inputs(dev, 2, k, tile, seed=seed)
    a = a.cpu().numpy()
    origin = origin.cpu().numpy()
    r = np.random.default_rng(seed)
    if kind == "mixed":
        for t in range(2):
            ox, oy = origin[t]
            a[t, :, 0] = [ox + tile / 2, oy + tile / 2, 1 / 9.0, 0.0,
                          1 / 9.0, 0.003, 0.2, 0.5, 0.9, a[t, 9, 0], 1.0]
            a[t, :, 1] = [ox + tile / 2, oy + 1.0, 6.25, 0.0, 6.25, 0.9, 0.8,
                          0.1, 0.3, a[t, 9, 1], 1.0]
            a[t, :, 2] = [ox + tile / 2, oy + tile / 2, 1e-6, 0.0, 1e-6, 1.0,
                          0.4, 0.6, 0.2, a[t, 9, 2], 1.0]
    elif kind == "dead_warps":
        live = a[:, 10] > 0
        a[:, 1] = origin[:, 1:2] + r.uniform(0.0, 1.5, (2, k))
        sig = r.uniform(0.3, 0.6, (2, k))
        a[:, 2] = a[:, 4] = 1.0 / sig ** 2
        a[:, 3] = 0.0
        a[:, :, ~live[0]] = 0.0
    else:
        a[:, 2:5, 0::3] = [[1e-6], [0.0], [1e-6]]
        a[:, 5, 0::3] = 1.0
    to = lambda x: torch.from_numpy(np.asarray(x, np.float32)).to(dev)  # noqa
    return to(a), to(origin), g


@pytest.mark.parametrize("kind", ["mixed", "dead_warps", "saturated"])
@pytest.mark.parametrize("tile,k", [(16, 32), (16, 100), (8, 40),
                                    (32, 48)])
def test_gs_blend_bwd_warp_vote_matches_plain(cuda, kind, tile, k):
    """B18 against `gs_blend_bwd_plain` at 1e-4 of each row's largest, on
    tiles where whole warps take no slot, a slot is below the floor
    everywhere, or saturated everywhere; the rows the skip leaves out must
    be exact zeros."""
    from nr3d_lib_tpu_torch.graphics import gaussian_splatting as GS

    a, origin, g = _gs_liveness_tile(cuda, tile, k, kind, seed=tile + k)
    live = GS._alpha_parts(a, origin, tile, GS_FLOOR)[5]          # [T,P,K]
    if kind == "dead_warps":
        assert not live[:, 4 * tile:].any()       # the lower warps take none
    if kind == "mixed":
        assert not live[:, :, 0].any() and live[:, :, 2].all()
        assert live[:, :2 * tile, 1].any() and not live[:, 2 * tile:, 1].any()
    got = GS._bwd_cuda(a, origin, *g, GS_BG, tile, GS_FLOOR)
    torch.cuda.synchronize()
    want = GS.gs_blend_bwd_plain(a, origin, *g, GS_BG, tile, GS_FLOOR)
    for r in range(11):
        torch.testing.assert_close(
            got[:, r], want[:, r], rtol=0,
            atol=1e-4 * float(want[:, r].abs().max()) + 1e-9)
    never = ~live.any(1)                                          # [T, K]
    assert not got.permute(0, 2, 1)[never].any()     # no pixel: exact zeros
    if kind == "mixed":
        assert not got[:, :6, 2].any()               # saturated: dL/dα is 0
        assert got[:, 6:10, 2].all()


def test_gs_blend_bwd_bench_scene_matches_plain(cuda):
    """B18 at the bench scene's own per-tile attrs (bench.py S5: 500,000
    gaussians, 512², tile 16, capacity 256), upstream gradients from
    numpy, against its plain version at 1e-4 of each row's largest."""
    from nr3d_lib_tpu_torch import bridge
    from nr3d_lib_tpu_torch.graphics import gaussian_splatting as GS

    r = np.random.default_rng(21)
    n = 500_000
    q = r.normal(size=(n, 4))
    params = {"means": r.uniform(-1.0, 1.0, (n, 3)),
              "scales": r.uniform(0.002, 0.02, (n, 3)),
              "quats": q / np.linalg.norm(q, axis=-1, keepdims=True),
              "opac": r.uniform(0.3, 0.9, (n, 1)),
              "cols": r.uniform(0.0, 1.0, (n, 3))}
    p = bridge.gaussians_from_jax(
        {k: v.astype(np.float32) for k, v in params.items()}, device=cuda)
    w2c = torch.eye(4, device=cuda)
    w2c[2, 3] = 3.0
    intr = torch.tensor([[500.0, 0, 256], [0, 500.0, 256], [0, 0, 1]],
                        device=cuda)
    with torch.no_grad():
        attrs, origin, _, _ = GS._tile_attrs(
            p["means"], p["scales"], p["quats"], p["opac"], p["cols"], w2c,
            intr, (512, 512), tile=16, tiles_per_gaussian=16,
            tile_capacity=256)
    n_t = attrs.shape[0]
    g = tuple(torch.from_numpy(r.normal(size=s).astype(np.float32)).to(cuda)
              for s in ((n_t, 256, 3), (n_t, 256), (n_t, 256)))
    got = GS._bwd_cuda(attrs, origin, *g, (0.0, 0.0, 0.0), 16, GS_FLOOR)
    torch.cuda.synchronize()
    want = GS.gs_blend_bwd_plain(attrs, origin, *g, (0.0, 0.0, 0.0), 16,
                                 GS_FLOOR)
    for r_ in range(11):
        torch.testing.assert_close(
            got[:, r_], want[:, r_], rtol=0,
            atol=1e-4 * float(want[:, r_].abs().max()) + 1e-9)


# ---------------------- B10: level-major warps over runs of points
def _pc_ray_points(dev, d: int, n_rays: int, per_ray: int, seed: int):
    """Points in [0,1]^d along seeded rays, sorted along each ray as a
    render's sample slab (the first three coordinates; any further ones
    constant along a ray, as the dynamic field's time)."""
    r = np.random.default_rng(seed)
    o = r.uniform(0.0, 1.0, (n_rays, 1, d))
    v = r.normal(size=(n_rays, 1, d))
    v[..., 3:] = 0.0
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    t = np.sort(r.uniform(0.0, 0.8, (n_rays, per_ray, 1)), 1)
    x = np.clip(o + v * t, 0.0, 1.0).reshape(-1, d).astype(np.float32)
    return torch.from_numpy(x).to(dev)


PC_ALL_D = {2: [4.0, 12.0, 40.0], 3: [16.0 * 2 ** (0.5 * i) for i in
                                      range(8)],
            4: [8.0, 16.0, 32.0, 64.0, 128.0], 5: [2.0, 6.0, 18.0]}


@pytest.mark.parametrize("d", sorted(PC_ALL_D))
@pytest.mark.parametrize("n", [1, 7, 31, 33, 1000, 96 * 1001])
def test_permuto_fwd_ray_and_permuted_order(cuda, d, n):
    """B10 on points along rays (the order the paths feed) and on the same
    points permuted: each within 1e-5 of the plain version, and the
    permuted rows bitwise the ray order's rows permuted (a point's
    encoding does not depend on its neighbours in the run). n covers a
    single point, n < 32, a ragged last run and many runs; d = 2–5, and
    d = 3 holds the 3D lattice's dense level."""
    meta = PC.make_permuto_cell_meta(d, PC_ALL_D[d], 4096)
    if d == 3:
        assert any(lv.box_dims is not None for lv in meta.levels)
    x = _pc_ray_points(cuda, d, -(-n // 96), 96, seed=d)[:n].contiguous()
    rng = np.random.default_rng(d + 50)
    table = torch.from_numpy(rng.uniform(
        -0.1, 0.1, (meta.total_rows, 128)).astype(np.float32)).to(cuda)
    perm = torch.from_numpy(rng.permutation(n)).to(cuda)
    x_perm = x[perm].contiguous()
    before = _build.LAUNCHES["permuto_fwd"]
    with torch.no_grad():
        y = PC.permuto_cell_encode(x, table, meta)
        y_perm = PC.permuto_cell_encode(x_perm, table, meta)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["permuto_fwd"] == before + 2
    assert y.shape == (n, 2 * meta.n_levels)
    _close(y, PC.permuto_cell_encode_xla(x, table, meta), 1e-5)
    _close(y_perm, PC.permuto_cell_encode_xla(x_perm, table, meta), 1e-5)
    assert torch.equal(y_perm, y[perm])


def test_permuto_fwd_empty(cuda):
    meta = PC.make_permuto_cell_meta(4, PC_ALL_D[4], 4096)
    table = torch.zeros(meta.total_rows, 128, device=cuda)
    y = PC.permuto_cell_encode(torch.zeros(0, 4, device=cuda), table, meta)
    torch.cuda.synchronize()
    assert y.shape == (0, 10)


# ------------- B14/B15: level-major warps, warp-aggregated atomics, and
# the simplex search's exact shortcuts
def _p4_ray_inputs(dev, d: int, n: int):
    """Path-like inputs of the F=4 cell kernels at dimension d: points
    along rays (`_pc_ray_points`), the same points permuted, a table and
    upstream gradients from seeds."""
    meta = P4.make_permuto_cell4_meta(d, PC_ALL_D[d], 4096)
    x = _pc_ray_points(dev, d, -(-n // 96), 96, seed=d + 10)[:n].contiguous()
    rng = np.random.default_rng(d + 60)
    table = torch.from_numpy(rng.uniform(
        -0.1, 0.1, (meta.total_rows, 256)).astype(np.float32)).to(dev)
    g = torch.from_numpy(rng.normal(size=(n, 4 * meta.n_levels)).astype(
        np.float32)).to(dev)
    perm = torch.from_numpy(rng.permutation(n)).to(dev)
    return meta, x, table, g, perm


@pytest.mark.parametrize("d", sorted(PC_ALL_D))
@pytest.mark.parametrize("n", [1, 7, 31, 33, 1000, 96 * 1001])
def test_permuto4_fwd_ray_and_permuted_order(cuda, d, n):
    """B14 on points along rays and on the same points permuted: each
    within 1e-5 of the plain version, and the permuted rows bitwise the
    ray order's rows permuted. n covers a single point, n < 32, a ragged
    last run and many runs; d = 2–5 (d = 3 with a dense level)."""
    meta, x, table, _, perm = _p4_ray_inputs(cuda, d, n)
    x_perm = x[perm].contiguous()
    before = _build.LAUNCHES["permuto4_fwd"]
    with torch.no_grad():
        y = P4.permuto_cell4_encode(x, table, meta)
        y_perm = P4.permuto_cell4_encode(x_perm, table, meta)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["permuto4_fwd"] == before + 2
    assert y.shape == (n, 4 * meta.n_levels)
    _close(y, P4.permuto_cell4_encode_xla(x, table, meta), 1e-5)
    _close(y_perm, P4.permuto_cell4_encode_xla(x_perm, table, meta), 1e-5)
    assert torch.equal(y_perm, y[perm])


@pytest.mark.parametrize("d", sorted(PC_ALL_D))
@pytest.mark.parametrize("n", [1, 7, 31, 33, 1000, 96 * 1001])
def test_permuto4_bwd_ray_and_permuted_order(cuda, d, n):
    """B15 (warp-aggregated atomics) at ray order and permuted, without
    and with dL/dx, against the plain version; dL/dx is summed over the
    levels in a block, so it is bitwise the same in both orders."""
    meta, x, table, g, perm = _p4_ray_inputs(cuda, d, n)
    packed = P4.pack_table4(table)
    dxs = []
    for xx, gg in ((x, g), (x[perm].contiguous(), g[perm].contiguous())):
        dx_p, dtab_p = P4.permuto_cell4_encode_bwd_xla(xx, table, gg, meta,
                                                       True)
        for need_dx in (False, True):
            before = _build.LAUNCHES["permuto4_bwd"]
            dx, dtab = P4._bwd_cuda(xx, gg, meta, need_dx=need_dx,
                                    packed=packed)
            torch.cuda.synchronize()
            assert _build.LAUNCHES["permuto4_bwd"] == before + 1
            _close(dtab, dtab_p, 1e-5)
            if need_dx:
                _close(dx, dx_p, 1e-4)
                dxs.append(dx)
            else:
                assert dx is None
    assert torch.equal(dxs[1], dxs[0][perm])


def test_permuto4_bwd_one_cell_warps(cuda):
    """Every warp's 32 points in one cell at every level (one group per
    vertex and warp; level 0 dense): the groups' sums against the plain
    version, and the count of atomics the aggregation leaves."""
    meta = P4.make_permuto_cell4_meta(3, PC_ALL_D[3], 4096)
    assert meta.levels[0].kind == "dense"
    rng = np.random.default_rng(70)
    n_warps = 500
    x = np.repeat(rng.uniform(0.0, 1.0, (n_warps, 3)), 32, 0)
    x = torch.from_numpy(x.astype(np.float32)).to(cuda)
    table = torch.from_numpy(rng.uniform(
        -0.1, 0.1, (meta.total_rows, 256)).astype(np.float32)).to(cuda)
    g = torch.from_numpy(rng.normal(size=(len(x), 4 * meta.n_levels))
                         .astype(np.float32)).to(cuda)
    assert PC.atomic_groups(x, meta) == [n_warps * 4] * meta.n_levels
    dx, dtab = P4._bwd_cuda(x, g, meta, need_dx=True,
                            packed=P4.pack_table4(table))
    dx_p, dtab_p = P4.permuto_cell4_encode_bwd_xla(x, table, g, meta, True)
    _close(dtab, dtab_p, 1e-5)
    _close(dx, dx_p, 1e-4)


def test_permuto4_empty(cuda):
    meta = P4.make_permuto_cell4_meta(4, PC_ALL_D[4], 4096)
    table = torch.zeros(meta.total_rows, 256, device=cuda)
    x = torch.zeros(0, 4, device=cuda)
    y = P4.permuto_cell4_encode(x, table, meta)
    g = torch.zeros(0, 4 * meta.n_levels, device=cuda)
    for need_dx in (False, True):
        dx, dtab = P4._bwd_cuda(x, g, meta, need_dx=need_dx,
                                packed=P4.pack_table4(table))
        torch.cuda.synchronize()
        assert dtab.shape == (meta.total_rows, 256) and \
            not dtab.any()
        assert dx is None if not need_dx else dx.shape == (0, 4)
    assert y.shape == (0, 4 * meta.n_levels)


def _check_out(dev):
    """{count of inputs that differ, lowest one} of a self-check."""
    return torch.tensor([0, -1], dtype=torch.int64, device=dev)


@pytest.mark.parametrize("b", [3, 4, 5, 6])
def test_search_division_is_the_ieee_quotient(cuda, b):
    """The search's division by d+1 (`div_dp1`, a product and two FMAs for
    3 and 5, a product by 0.25 for 4, `__fdiv_rn` for 6) against x / b,
    bit for bit, on all 2^32 floats (two not-a-numbers count as equal),
    for each d+1 of the instantiated d = 2–5."""
    out = _check_out(cuda)
    _build.check(P4._lib().pc_check_div(b, out.data_ptr(),
                                        _build.stream_ptr(cuda)),
                 "pc_check_div")
    torch.cuda.synchronize()
    assert out[0].item() == 0, f"first differing pattern {out[1].item():#x}"


FASTMOD_METAS = {"pathc": (4, [4.0, 11.0, 32.0, 90.0], 4096),
                 "pathd": (4, [8.0, 16.0, 32.0, 64.0, 128.0], 4096),
                 "bench3d": (3, [16.0 * 2 ** (0.5 * i) for i in range(8)],
                             4096),
                 "odd": (2, [3.3, 77.7, 1000.0], 1000)}


@pytest.mark.parametrize("meta_name", sorted(FASTMOD_METAS))
def test_search_modulus_is_exact(cuda, meta_name):
    """`pc_mod` with each level's constants from `c_meta` against h % m,
    for all 2^32 hashes h."""
    meta = PC.make_permuto_cell_meta(*FASTMOD_METAS[meta_name])
    cm = PC.c_meta(meta)
    for level in range(meta.n_levels):
        out = _check_out(cuda)
        _build.check(P4._lib().pc_check_mod(cm, level, out.data_ptr(),
                                            _build.stream_ptr(cuda)),
                     "pc_check_mod")
        torch.cuda.synchronize()
        assert out[0].item() == 0, (level, cm.lv[level].hash_mod,
                                    hex(out[1].item()))


def test_search_modulus_is_exact_for_any_modulus(cuda):
    """The same for moduli the metas do not hold: 1, powers of two,
    2^32 − 1 and seeded ones in [1, 2^24]."""
    cm = PC.c_meta(PC.make_permuto_cell_meta(2, [4.0], 4096))
    rng = np.random.default_rng(80)
    for m in [1, 2, 3, 7, 1 << 13, (1 << 31) - 1, 1 << 31, (1 << 32) - 1] + \
            [int(v) for v in rng.integers(1, (1 << 24) + 1, 8)]:
        lv = cm.lv[0]
        lv.hash_mod = m
        lv.mod_magic, lv.mod_sh1, lv.mod_sh2 = PC.fastmod_constants(m)
        out = _check_out(cuda)
        _build.check(P4._lib().pc_check_mod(cm, 0, out.data_ptr(),
                                            _build.stream_ptr(cuda)),
                     "pc_check_mod")
        torch.cuda.synchronize()
        assert out[0].item() == 0, (m, hex(out[1].item()))


# ------------- B11/B12 and B9: level-major warps, warp-aggregated float2
# atomics, dL/dx summed over the levels in the block
@pytest.mark.parametrize("d", sorted(PC_ALL_D))
@pytest.mark.parametrize("n", [1, 7, 31, 33, 1000, 96 * 1001])
def test_permuto_bwd_ray_and_permuted_order(cuda, d, n):
    """B11 and B12 at ray order and permuted, against the plain version;
    B12's dL/dx is summed over the levels in a block, so it is bitwise
    the same in two runs and in both orders. n covers a single point,
    n < 32, a ragged last run and many runs; d = 2–5 (d = 3 with the 3D
    lattice's dense level)."""
    meta = PC.make_permuto_cell_meta(d, PC_ALL_D[d], 4096)
    if d == 3:
        assert any(lv.box_dims is not None for lv in meta.levels)
    x = _pc_ray_points(cuda, d, -(-n // 96), 96, seed=d + 20)[:n].contiguous()
    rng = np.random.default_rng(d + 70)
    table = torch.from_numpy(rng.uniform(
        -0.1, 0.1, (meta.total_rows, 128)).astype(np.float32)).to(cuda)
    g = torch.from_numpy(rng.normal(size=(n, 2 * meta.n_levels)).astype(
        np.float32)).to(cuda)
    perm = torch.from_numpy(rng.permutation(n)).to(cuda)
    dxs = []
    for xx, gg in ((x, g), (x[perm].contiguous(), g[perm].contiguous())):
        dx_p, dtab_p = PC.permuto_cell_encode_bwd_xla(xx, table, gg, meta,
                                                      True)
        for need_dx in (False, True):
            before = _build.LAUNCHES["permuto_bwd"]
            dx, dtab = PC._bwd_cuda(xx, gg, meta, need_dx=need_dx,
                                    table=table)
            torch.cuda.synchronize()
            assert _build.LAUNCHES["permuto_bwd"] == before + 1
            _close(dtab, dtab_p, 1e-5)
            if need_dx:
                _close(dx, dx_p, 1e-4)
                again, _ = PC._bwd_cuda(xx, gg, meta, need_dx=True,
                                        table=table)
                assert torch.equal(again, dx)
                dxs.append(dx)
            else:
                assert dx is None
    assert torch.equal(dxs[1], dxs[0][perm])


def test_permuto_bwd_one_cell_warps(cuda):
    """Every warp's 32 points in one cell at every level (one group per
    vertex and warp; level 0 dense): the groups' sums against the plain
    version, and the count of atomics the aggregation leaves."""
    meta = PC.make_permuto_cell_meta(3, PC_ALL_D[3], 4096)
    rng = np.random.default_rng(71)
    n_warps = 500
    x = np.repeat(rng.uniform(0.0, 1.0, (n_warps, 3)), 32, 0)
    x = torch.from_numpy(x.astype(np.float32)).to(cuda)
    table = torch.from_numpy(rng.uniform(
        -0.1, 0.1, (meta.total_rows, 128)).astype(np.float32)).to(cuda)
    g = torch.from_numpy(rng.normal(size=(len(x), 2 * meta.n_levels))
                         .astype(np.float32)).to(cuda)
    assert PC.atomic_groups(x, meta) == [n_warps * 4] * meta.n_levels
    dx, dtab = PC._bwd_cuda(x, g, meta, need_dx=True, table=table)
    dx_p, dtab_p = PC.permuto_cell_encode_bwd_xla(x, table, g, meta, True)
    _close(dtab, dtab_p, 1e-5)
    _close(dx, dx_p, 1e-4)


def test_permuto_bwd_empty(cuda):
    meta = PC.make_permuto_cell_meta(4, PC_ALL_D[4], 4096)
    x = torch.zeros(0, 4, device=cuda)
    g = torch.zeros(0, 2 * meta.n_levels, device=cuda)
    table = torch.zeros(meta.total_rows, 128, device=cuda)
    for need_dx in (False, True):
        dx, dtab = PC._bwd_cuda(x, g, meta, need_dx=need_dx, table=table)
        torch.cuda.synchronize()
        assert dtab.shape == (meta.total_rows, 128) and not dtab.any()
        assert dx is None if not need_dx else dx.shape == (0, 4)


def _brick_ray_inputs(dev, meta_name: str, n: int, seed: int):
    """B9's inputs at points along rays (`_pc_ray_points`), from seeds."""
    lod_res, types, rows = F2_METAS[meta_name]
    meta = B.make_brick_meta(lod_res, types, rows)
    x = _pc_ray_points(dev, 3, max(-(-n // 96), 1), 96, seed)[:n].contiguous()
    rng = np.random.default_rng(seed + 1)
    table = torch.from_numpy(rng.uniform(
        -0.1, 0.1, (meta.total_rows, 128)).astype(np.float32)).to(dev)
    g = torch.from_numpy(rng.normal(size=(n, 2 * meta.n_levels)).astype(
        np.float32)).to(dev)
    gg = torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32)).to(dev)
    perm = torch.from_numpy(rng.permutation(n)).to(dev)
    return meta, x, table, g, gg, perm


@pytest.mark.parametrize("meta_name", sorted(F2_METAS))
@pytest.mark.parametrize("n", [0, 1, 31, 33, 1000, 96 * 1001])
def test_brick_bwd2_ray_and_permuted_order(cuda, meta_name, n):
    """B9 at ray order and permuted: dL/dg_up and dL/dx are each point's
    own sums (levels in order), so they are bitwise the same in two runs
    and in both orders once un-permuted; dL/dtable within its tolerance
    of the plain version. n = 0, n < 32 and a ragged last run."""
    meta, x, table, g, gg, perm = _brick_ray_inputs(cuda, meta_name, n, 90)
    outs = []
    for xx, g2, ggg in ((x, g, gg), (x[perm].contiguous(),
                                     g[perm].contiguous(),
                                     gg[perm].contiguous())):
        before = _build.LAUNCHES["brick_bwd2"]
        dg, dx, dtab = B._bwd2_cuda(g2, xx, table, ggg, meta)
        dg2, dx2, dtab2 = B._bwd2_cuda(g2, xx, table, ggg, meta)
        torch.cuda.synchronize()
        assert _build.LAUNCHES["brick_bwd2"] == before + 2
        assert dg.shape == (n, 2 * meta.n_levels) and dx.shape == (n, 3)
        assert torch.equal(dg, dg2) and torch.equal(dx, dx2)
        if n == 0:
            assert dtab.shape == (meta.total_rows, 128) and not dtab.any()
        else:
            dg_p, dx_p, dtab_p = B.brick_nablas_bwd_xla(g2, xx, table, ggg,
                                                        meta)
            _close(dg, dg_p, 1e-4)
            _close(dx, dx_p, 1e-4)
            _close(dtab, dtab_p, 1e-5)
            _close(dtab2, dtab_p, 1e-5)
        outs.append((dg, dx))
    inv = torch.argsort(perm)
    assert torch.equal(outs[1][0][inv], outs[0][0])
    assert torch.equal(outs[1][1][inv], outs[0][1])


def test_brick_bwd2_one_brick_warps(cuda):
    """Every warp's 32 points at one point of space (one group per corner
    and warp at every level): the groups' sums against the plain version,
    and the count of atomics the aggregation leaves."""
    meta = B.make_brick_meta(*F2_METAS["dense_hash"])
    rng = np.random.default_rng(91)
    n_warps = 300
    x = np.repeat(rng.uniform(0.0, 1.0, (n_warps, 3)), 32, 0)
    x = torch.from_numpy(x.astype(np.float32)).to(cuda)
    table = torch.from_numpy(rng.uniform(
        -0.1, 0.1, (meta.total_rows, 128)).astype(np.float32)).to(cuda)
    g = torch.from_numpy(rng.normal(size=(len(x), 2 * meta.n_levels))
                         .astype(np.float32)).to(cuda)
    gg = torch.from_numpy(rng.normal(size=(len(x), 3)).astype(
        np.float32)).to(cuda)
    assert B.brick_atomic_groups(x, meta) == [n_warps * 8] * meta.n_levels
    dg, dx, dtab = B._bwd2_cuda(g, x, table, gg, meta)
    dg_p, dx_p, dtab_p = B.brick_nablas_bwd_xla(g, x, table, gg, meta)
    _close(dg, dg_p, 1e-4)
    _close(dx, dx_p, 1e-4)
    _close(dtab, dtab_p, 1e-5)


# ------------------ B7: level-major warps over runs of points (as B9)
def _brick_bwd_ray_inputs(dev, n_levels: int, n: int, seed: int):
    """B7's inputs at points along rays, on the first `n_levels` levels of
    the eight-level meta (dense, then hashed), from seeds."""
    lod_res, types, rows = F2_METAS["eight_levels"]
    meta = B.make_brick_meta(lod_res[:n_levels], types[:n_levels], rows)
    x = _pc_ray_points(dev, 3, max(-(-n // 96), 1), 96, seed)[:n].contiguous()
    rng = np.random.default_rng(seed + 1)
    table = torch.from_numpy(rng.uniform(
        -0.1, 0.1, (meta.total_rows, 128)).astype(np.float32)).to(dev)
    g = torch.from_numpy(rng.normal(size=(n, 2 * n_levels)).astype(
        np.float32)).to(dev)
    perm = torch.from_numpy(rng.permutation(n)).to(dev)
    return meta, x, table, g, perm


@pytest.mark.parametrize("n_levels", range(1, 9))
@pytest.mark.parametrize("n", [0, 1, 31, 33, 1000, 96 * 1001])
@pytest.mark.parametrize("form", ["no_dx", "dx_corners", "dx_table"])
def test_brick_bwd_ray_and_permuted_order(cuda, n_levels, n, form):
    """B7 at ray order and permuted, L = 1-8: dL/dx is each point's own
    level sum, so it is bitwise the same in two runs and in both orders
    once un-permuted; dL/dtable and dL/dx within their tolerances of the
    plain version. n = 0, n < 32 and a ragged last run; dL/dx from the
    want_g corners or from the table."""
    meta, x, table, g, perm = _brick_bwd_ray_inputs(cuda, n_levels, n,
                                                    93 + n_levels)
    need_dx = form != "no_dx"
    dxs = []
    for xx, gg in ((x, g), (x[perm].contiguous(), g[perm].contiguous())):
        kw = {}
        if form == "dx_corners":
            kw["corners"] = B._fwd_cuda(xx, table, meta, want_g=True)[1]
        elif form == "dx_table":
            kw["table"] = table
        before = _build.LAUNCHES["brick_bwd"]
        dx, dtab = B._bwd_cuda(xx, gg, meta, need_dx=need_dx, **kw)
        dx2, dtab2 = B._bwd_cuda(xx, gg, meta, need_dx=need_dx, **kw)
        torch.cuda.synchronize()
        assert _build.LAUNCHES["brick_bwd"] == before + 2
        assert dtab.shape == (meta.total_rows, 128)
        if n == 0:
            assert not dtab.any()
        else:
            dx_p, dtab_p = B.brick_encode_bwd_xla(xx, table, gg, meta,
                                                  need_dx)
            _close(dtab, dtab_p, 1e-5)
            _close(dtab2, dtab_p, 1e-5)
            if need_dx:
                _close(dx, dx_p, 1e-4)
        if need_dx:
            assert dx.shape == (n, 3) and torch.equal(dx, dx2)
        else:
            assert dx is None and dx2 is None
        dxs.append(dx)
    if need_dx:
        assert torch.equal(dxs[1][torch.argsort(perm)], dxs[0])


def test_brick_bwd_one_brick_warps(cuda):
    """Every warp's 32 points at one point of space (one group per corner
    and warp at every level): the groups' sums against the plain
    version."""
    meta = B.make_brick_meta(*F2_METAS["dense_hash"])
    rng = np.random.default_rng(94)
    n_warps = 300
    x = np.repeat(rng.uniform(0.0, 1.0, (n_warps, 3)), 32, 0)
    x = torch.from_numpy(x.astype(np.float32)).to(cuda)
    table = torch.from_numpy(rng.uniform(
        -0.1, 0.1, (meta.total_rows, 128)).astype(np.float32)).to(cuda)
    g = torch.from_numpy(rng.normal(size=(len(x), 2 * meta.n_levels))
                         .astype(np.float32)).to(cuda)
    assert B.brick_atomic_groups(x, meta) == [n_warps * 8] * meta.n_levels
    corners = B._fwd_cuda(x, table, meta, want_g=True)[1]
    dx, dtab = B._bwd_cuda(x, g, meta, need_dx=True, corners=corners)
    dx_p, dtab_p = B.brick_encode_bwd_xla(x, table, g, meta, True)
    _close(dx, dx_p, 1e-4)
    _close(dtab, dtab_p, 1e-5)


# ------ B6: level-major warps, y and the corners out of shared memory
# the F=2 metas and the NeRF's six levels (blockDim 192)
F2_FWD_METAS = {**F2_METAS,
                "nerf_six": ([16, 32, 64, 128, 256, 512],
                             ["Dense"] * 3 + ["Hash"] * 3, 4096)}


@pytest.mark.parametrize("meta_name", sorted(F2_FWD_METAS))
@pytest.mark.parametrize("n", [0, 1, 31, 33, 1000, 96 * 1001])
def test_brick_fwd_ray_and_permuted_order(cuda, meta_name, n):
    """B6 in both forms at points along rays and permuted: y within its
    tolerance of the plain version and the same bits in the two forms,
    the corners equal to the plain version's, and a permuted batch's y
    the permuted y (a (point, level) computes alone). n = 0, n < 32 and a
    ragged last run; one launch counted a call."""
    lod_res, types, rows = F2_FWD_METAS[meta_name]
    meta = B.make_brick_meta(lod_res, types, rows)
    L = meta.n_levels
    x = _pc_ray_points(cuda, 3, max(-(-n // 96), 1), 96, 97)[:n].contiguous()
    rng = np.random.default_rng(98)
    table = torch.from_numpy(rng.uniform(
        -0.1, 0.1, (meta.total_rows, 128)).astype(np.float32)).to(cuda)
    perm = torch.from_numpy(rng.permutation(n)).to(cuda)
    ys = []
    for xx in (x, x[perm].contiguous()):
        before = (_build.LAUNCHES["brick_fwd"], _build.LAUNCHES["brick_fwd_g"])
        y = B._fwd_cuda(xx, table, meta)
        y_g, corners = B._fwd_cuda(xx, table, meta, want_g=True)
        torch.cuda.synchronize()
        assert (_build.LAUNCHES["brick_fwd"], _build.LAUNCHES["brick_fwd_g"]
                ) == (before[0] + 1, before[1] + 1)
        assert y.shape == (n, 2 * L) and corners.shape == (n, L, 8, 2)
        assert torch.equal(y, y_g)
        if n:
            _close(y, B.brick_encode_xla(xx, table, meta), 1e-5)
            assert torch.equal(corners,
                               B.brick_corner_values_xla(xx, table, meta))
        ys.append(y)
    assert torch.equal(ys[1], ys[0][perm])


# ------------- B2, B4: the F=4 backwards in level-major warps (as B7, B9)
B4_LEVELS = ([16, 32, 64, 128], ["Dense", "Dense", "Hash", "Hash"], 4096)


def _brick4_ray_inputs(dev, n_levels: int, n: int, seed: int):
    """B2's and B4's inputs at points along rays, on the first `n_levels`
    levels of a four-level F=4 meta (dense, then hashed), from seeds."""
    lod_res, types, rows = B4_LEVELS
    meta = B4.make_brick4_meta(lod_res[:n_levels], types[:n_levels], rows)
    x = _pc_ray_points(dev, 3, max(-(-n // 96), 1), 96, seed)[:n].contiguous()
    rng = np.random.default_rng(seed + 1)
    table = torch.from_numpy(rng.uniform(
        -0.1, 0.1, (meta.total_rows, 256)).astype(np.float32)).to(dev)
    g = torch.from_numpy(rng.normal(size=(n, 4 * n_levels)).astype(
        np.float32)).to(dev)
    gg = torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32)).to(dev)
    perm = torch.from_numpy(rng.permutation(n)).to(dev)
    return meta, x, table, g, gg, perm


@pytest.mark.parametrize("n_levels", range(1, 5))
@pytest.mark.parametrize("n", [0, 1, 255, 100_000])
@pytest.mark.parametrize("form", ["no_dx", "dx_words", "dx_table"])
def test_brick4_bwd_ray_and_permuted_order(cuda, n_levels, n, form):
    """B2 at ray order and permuted, L = 1-4: dL/dx is each point's own
    level sum, so it is bitwise the same in two runs and in both orders
    once un-permuted; dL/dtable and dL/dx within their tolerances of the
    plain version. n = 0, n < 32 and a ragged last run; dL/dx from the
    want_g words or from the packed table."""
    meta, x, table, g, _, perm = _brick4_ray_inputs(cuda, n_levels, n,
                                                    120 + n_levels)
    packed = B4.pack_table4(table)
    need_dx = form != "no_dx"
    dxs = []
    for xx, gp in ((x, g), (x[perm].contiguous(), g[perm].contiguous())):
        kw = {}
        if form == "dx_words":
            kw["words"] = B4._fwd_cuda(xx, packed, meta, want_g=True)[1]
        elif form == "dx_table":
            kw["packed"] = packed
        before = _build.LAUNCHES["brick4_bwd"]
        dx, dtab = B4._bwd_cuda(xx, gp, meta, need_dx=need_dx, **kw)
        dx2, dtab2 = B4._bwd_cuda(xx, gp, meta, need_dx=need_dx, **kw)
        torch.cuda.synchronize()
        assert _build.LAUNCHES["brick4_bwd"] == before + 2
        assert dtab.shape == (meta.total_rows, 256)
        if n == 0:
            assert not dtab.any()
        else:
            dx_p, dtab_p = B4.brick4_encode_bwd_xla(xx, table, gp, meta,
                                                    need_dx)
            _close(dtab, dtab_p, 1e-5)
            _close(dtab2, dtab_p, 1e-5)
            if need_dx:
                _close(dx, dx_p, 1e-4)
        if need_dx:
            assert dx.shape == (n, 3) and torch.equal(dx, dx2)
        else:
            assert dx is None and dx2 is None
        dxs.append(dx)
    if need_dx:
        assert torch.equal(dxs[1][torch.argsort(perm)], dxs[0])


@pytest.mark.parametrize("n_levels", range(1, 5))
@pytest.mark.parametrize("n", [0, 1, 255, 100_000])
def test_brick4_bwd2_ray_and_permuted_order(cuda, n_levels, n):
    """B4 at ray order and permuted, L = 1-4: dL/dg_up and dL/dx are each
    point's own sums (levels in order), so they are bitwise the same in
    two runs and in both orders once un-permuted; all three gradients
    within their tolerances of the plain version, and without dL/dx the
    same dL/dg_up. n = 0, n < 32 and a ragged last run."""
    meta, x, table, g, gg, perm = _brick4_ray_inputs(cuda, n_levels, n,
                                                     130 + n_levels)
    packed = B4.pack_table4(table)
    outs = []
    for xx, gp, ggp in ((x, g, gg), (x[perm].contiguous(),
                                     g[perm].contiguous(),
                                     gg[perm].contiguous())):
        before = _build.LAUNCHES["brick4_bwd2"]
        dg, dx, dtab = B4._bwd2_cuda(gp, xx, packed, ggp, meta)
        dg2, dx2, dtab2 = B4._bwd2_cuda(gp, xx, packed, ggp, meta,
                                        need_dx=False)
        torch.cuda.synchronize()
        assert _build.LAUNCHES["brick4_bwd2"] == before + 2
        assert dg.shape == (n, 4 * n_levels) and dx.shape == (n, 3)
        assert dx2 is None and torch.equal(dg, dg2)
        if n == 0:
            assert dtab.shape == (meta.total_rows, 256) and not dtab.any()
        else:
            dg_p, dx_p, dtab_p = B4.brick4_nablas_bwd_xla(gp, xx, table, ggp,
                                                          meta)
            _close(dg, dg_p, 1e-4)
            _close(dx, dx_p, 1e-4)
            _close(dtab, dtab_p, 1e-5)
            _close(dtab2, dtab_p, 1e-5)
        dg3, dx3, _ = B4._bwd2_cuda(gp, xx, packed, ggp, meta)
        assert torch.equal(dg, dg3) and torch.equal(dx, dx3)
        outs.append((dg, dx))
    inv = torch.argsort(perm)
    assert torch.equal(outs[1][0][inv], outs[0][0])
    assert torch.equal(outs[1][1][inv], outs[0][1])


def _brick4_one_brick_inputs(dev, seed: int):
    """Every warp's 32 points at one point of space (one group per corner
    and warp at every level, the most the aggregation merges), on the
    production levels."""
    meta = B4.make_brick4_meta(*META_ARGS)
    rng = np.random.default_rng(seed)
    n_warps = 300
    x = np.repeat(rng.uniform(0.0, 1.0, (n_warps, 3)), 32, 0)
    x = torch.from_numpy(x.astype(np.float32)).to(dev)
    table = torch.from_numpy(rng.uniform(
        -0.1, 0.1, (meta.total_rows, 256)).astype(np.float32)).to(dev)
    g = torch.from_numpy(rng.normal(size=(len(x), 4 * meta.n_levels))
                         .astype(np.float32)).to(dev)
    gg = torch.from_numpy(rng.normal(size=(len(x), 3)).astype(
        np.float32)).to(dev)
    assert B.brick_atomic_groups(x, meta) == [n_warps * 8] * meta.n_levels
    return meta, x, table, g, gg


def test_brick4_bwd_one_brick_warps(cuda):
    """B2 where each warp's lanes all add to the same 8 slots: the groups'
    sums against the plain version."""
    meta, x, table, g, _ = _brick4_one_brick_inputs(cuda, 140)
    words = B4._fwd_cuda(x, B4.pack_table4(table), meta, want_g=True)[1]
    dx, dtab = B4._bwd_cuda(x, g, meta, need_dx=True, words=words)
    dx_p, dtab_p = B4.brick4_encode_bwd_xla(x, table, g, meta, True)
    _close(dx, dx_p, 1e-4)
    _close(dtab, dtab_p, 1e-5)


def test_brick4_bwd2_one_brick_warps(cuda):
    """B4 where each warp's lanes all add to the same 8 slots: the groups'
    sums against the plain version."""
    meta, x, table, g, gg = _brick4_one_brick_inputs(cuda, 141)
    dg, dx, dtab = B4._bwd2_cuda(g, x, B4.pack_table4(table), gg, meta)
    dg_p, dx_p, dtab_p = B4.brick4_nablas_bwd_xla(g, x, table, gg, meta)
    _close(dg, dg_p, 1e-4)
    _close(dx, dx_p, 1e-4)
    _close(dtab, dtab_p, 1e-5)


# -------------------------- B17: the per-warp cull of the slots
def _gs_cull_case(dev, kind: str, n_t: int, k: int, tile: int, seed: int):
    if kind == "near_floor":
        return near_floor_tiles(dev, n_t, k, tile, seed)[:2]
    a, origin, _ = _gs_blend_inputs(dev, n_t, k, tile, seed=seed)
    if kind == "all_dead":
        a[:, 10] = 0.0
    else:                  # "degenerate": conics with λ_min ≤ 0 among them
        c00, c11 = a[:, 2], a[:, 4]
        a[:, 3, 0::3] = 1.5 * torch.sqrt(c00 * c11)[:, 0::3]   # indefinite
        a[:, 3, 1::3] = torch.sqrt(c00 * c11)[:, 1::3]         # singular
        a[:, 2, 2::5] = -a[:, 2, 2::5]                         # negative
    return a, origin


@pytest.mark.parametrize("kind", ["near_floor", "degenerate", "all_dead"])
@pytest.mark.parametrize("k", [1, 32, 256])
@pytest.mark.parametrize("tile", [8, 16])
def test_gs_blend_cull_matches_plain(cuda, kind, k, tile):
    """B17 with its cull against `gs_blend_plain` at 1e-5 of each output's
    largest entry: slots within ulps of the α floor on either side, conics
    with λ_min ≤ 0 (never skipped), tiles of dead slots only (rgb the
    background exactly)."""
    from nr3d_lib_tpu_torch.graphics import gaussian_splatting as GS

    a, origin = _gs_cull_case(cuda, kind, 7, k, tile, seed=95 + k + tile)
    with torch.no_grad():
        out = GS.gs_blend(a, origin, GS_BG, tile, GS_FLOOR)
    torch.cuda.synchronize()
    ref = GS.gs_blend_plain(a, origin, GS_BG, tile, GS_FLOOR)
    for got, want in zip(out, ref):
        assert bool(torch.isfinite(got).all() == torch.isfinite(want).all())
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=1e-5 * float(want.abs().max()) + 1e-7)
    if kind == "all_dead":
        assert not out[1].any()
        assert torch.equal(out[0], torch.tensor(GS_BG, device=cuda).expand(
            out[0].shape))


@pytest.mark.parametrize("tile", [5, 12, 32])
def test_gs_blend_cull_other_tiles_match_plain(cuda, tile):
    """The cull on tiles where 8 does not divide the tile (a warp takes a
    row-major run of pixels, the last one partly past the tile) and on a
    32² tile (32 warps of 8 x 4 boxes), near the floor."""
    from nr3d_lib_tpu_torch.graphics import gaussian_splatting as GS

    a, origin, target = near_floor_tiles(cuda, 3, 64, tile, seed=tile)
    live = GS._alpha_parts(a, origin, tile, GS_FLOOR)[5]
    at = torch.gather(live, 1, target[:, None, :])[:, 0]
    assert at.any() and not at.all()            # both sides of the floor
    with torch.no_grad():
        out = GS.gs_blend(a, origin, GS_BG, tile, GS_FLOOR)
    torch.cuda.synchronize()
    for got, want in zip(out, GS.gs_blend_plain(a, origin, GS_BG, tile,
                                                GS_FLOOR)):
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=1e-5 * float(want.abs().max()) + 1e-7)


# ------- B13: level-major warps, the levels summed in the block in order
@pytest.mark.parametrize("meta_name", sorted(PC_METAS))
@pytest.mark.parametrize("n", [0, 1, 31, 33, 1000, 96 * 1001])
def test_permuto_dydx_ray_and_permuted_order(cuda, meta_name, n):
    """B13 at path D's meta and the 3D lattice's, on points along rays
    and the same points permuted: dx within 1e-4 of the plain version,
    and a permuted batch's dx bitwise the permuted dx (each point's
    levels are summed in its block, in level order). n = 0, n < 32, a
    ragged last run and many runs; one launch counted a call."""
    dim, res, rows = PC_METAS[meta_name]
    meta = PC.make_permuto_cell_meta(dim, res, rows)
    x = _pc_ray_points(cuda, dim, max(-(-n // 96), 1), 96,
                       dim + 140)[:n].contiguous()
    rng = np.random.default_rng(dim + 141)
    table = torch.from_numpy(rng.uniform(
        -0.1, 0.1, (meta.total_rows, 128)).astype(np.float32)).to(cuda)
    g = torch.from_numpy(rng.normal(size=(n, 2 * meta.n_levels)).astype(
        np.float32)).to(cuda)
    perm = torch.from_numpy(rng.permutation(n)).to(cuda)
    dxs = []
    for xx, gg in ((x, g), (x[perm].contiguous(), g[perm].contiguous())):
        before = _build.LAUNCHES["permuto_dydx"]
        with torch.no_grad():
            dx = PC.permuto_cell_nablas(gg, xx, table, meta)
        torch.cuda.synchronize()
        assert _build.LAUNCHES["permuto_dydx"] == before + 1
        assert dx.shape == (n, dim)
        if n:
            _close(dx, PC.permuto_cell_nablas_xla(gg, xx, table, meta), 1e-4)
        dxs.append(dx)
    assert torch.equal(dxs[1], dxs[0][perm])



# ------ B16: B13's blocks at F=4, the rank table and the level sum in them
@pytest.mark.parametrize("meta_name", sorted(P4_METAS))
@pytest.mark.parametrize("n", [0, 1, 31, 33, 1000, 96 * 1001])
def test_permuto4_dydx_ray_and_permuted_order(cuda, meta_name, n):
    """B16 at path C's meta (d = 4) and a small 3D one, on points along
    rays and the same points permuted: dx within 1e-4 of the plain
    version, and a permuted batch's dx bitwise the permuted dx (each
    point's levels are summed in its block, in level order). n = 0,
    n < 32, a ragged last run and many runs; one launch counted a
    call."""
    dim, res, rows = P4_METAS[meta_name]
    meta = P4.make_permuto_cell4_meta(dim, res, rows)
    x = _pc_ray_points(cuda, dim, max(-(-n // 96), 1), 96,
                       dim + 160)[:n].contiguous()
    rng = np.random.default_rng(dim + 161)
    table = torch.from_numpy(rng.uniform(
        -0.1, 0.1, (meta.total_rows, 256)).astype(np.float32)).to(cuda)
    g = torch.from_numpy(rng.normal(size=(n, 4 * meta.n_levels)).astype(
        np.float32)).to(cuda)
    perm = torch.from_numpy(rng.permutation(n)).to(cuda)
    dxs = []
    for xx, gg in ((x, g), (x[perm].contiguous(), g[perm].contiguous())):
        before = _build.LAUNCHES["permuto4_dydx"]
        with torch.no_grad():
            dx = P4.permuto_cell4_nablas(gg, xx, table, meta)
        torch.cuda.synchronize()
        assert _build.LAUNCHES["permuto4_dydx"] == before + 1
        assert dx.shape == (n, dim)
        if n:
            _close(dx, P4.permuto_cell4_nablas_xla(gg, xx, table, meta), 1e-4)
        dxs.append(dx)
    assert torch.equal(dxs[1], dxs[0][perm])


# --------------------- B8: B9's blocks, the levels summed in the block
@pytest.mark.parametrize("meta_name", sorted(F2_METAS))
@pytest.mark.parametrize("n", [0, 1, 31, 33, 1000, 96 * 1001])
def test_brick_dydx_ray_and_permuted_order(cuda, meta_name, n):
    """B8 at both F=2 metas (4 and 8 levels), on points along rays and
    the same points permuted: dx within 1e-4 of the plain version, and a
    permuted batch's dx bitwise the permuted dx (each point's levels are
    summed in its block, in level order). n = 0, n < 32, a ragged last
    run and many runs; one launch counted a call."""
    meta, x, table, g, _, perm = _brick_ray_inputs(cuda, meta_name, n, 170)
    dxs = []
    for xx, gg in ((x, g), (x[perm].contiguous(), g[perm].contiguous())):
        before = _build.LAUNCHES["brick_dydx"]
        with torch.no_grad():
            dx = B.brick_nablas(gg, xx, table, meta)
        torch.cuda.synchronize()
        assert _build.LAUNCHES["brick_dydx"] == before + 1
        assert dx.shape == (n, 3)
        if n:
            _close(dx, B.brick_nablas_xla(gg, xx, table, meta), 1e-4)
        dxs.append(dx)
    assert torch.equal(dxs[1], dxs[0][perm])

# --------- B1 want_g: the block's corner words out as coalesced uint4 runs
@pytest.mark.parametrize("n_levels", range(1, 5))
@pytest.mark.parametrize("n", [0, 1, 31, 33, 1000, 96 * 1001])
def test_brick4_want_g_ray_and_permuted_order(cuda, n_levels, n):
    """B1's want_g form on points along rays and permuted, L = 1-4: the
    words equal to the plain version's, y within 1e-5 of it and the same
    bits as the y-only form's, and a permuted batch's outputs the
    permuted outputs. n = 0, n < 32 and runs of 32 cut short; one launch
    counted a call of each form."""
    meta, x, table, _, _, perm = _brick4_ray_inputs(cuda, n_levels, n,
                                                    150 + n_levels)
    packed = B4.pack_table4(table)
    outs = []
    for xx in (x, x[perm].contiguous()):
        before = (_build.LAUNCHES["brick4_fwd"],
                  _build.LAUNCHES["brick4_fwd_g"])
        y = B4._fwd_cuda(xx, packed, meta)
        y_g, words = B4._fwd_cuda(xx, packed, meta, want_g=True)
        torch.cuda.synchronize()
        assert (_build.LAUNCHES["brick4_fwd"], _build.LAUNCHES["brick4_fwd_g"]
                ) == (before[0] + 1, before[1] + 1)
        assert y_g.shape == (n, 4 * n_levels)
        assert words.shape == (n, n_levels, 8, 2)
        assert torch.equal(y_g, y)
        if n:
            _close(y_g, B4.brick4_encode_xla(xx, table, meta), 1e-5)
            assert torch.equal(words,
                               B4.brick4_corner_words_xla(xx, table, meta))
        outs.append((y_g, words))
    assert torch.equal(outs[1][0], outs[0][0][perm])
    assert torch.equal(outs[1][1], outs[0][1][perm])


# -------- B3: a thread a point, the levels unrolled (an instance for L = 1-4)
@pytest.mark.parametrize("n_levels", [0, 1, 3, 4])
@pytest.mark.parametrize("n", [1, 31, 33, 100_000])
def test_brick4_dydx_ray_and_permuted_order(cuda, n_levels, n):
    """B3 on points along rays and the same points permuted, at L = 1, 3
    and 4 levels: dx within 1e-4 of the plain version, and a permuted
    batch's dx bitwise the permuted dx (each point sums its own levels in
    level order); at L = 0, dx all zeros. n < 32, a ragged last block and
    many blocks; one launch counted a call."""
    meta, x, table, g, _, perm = _brick4_ray_inputs(cuda, n_levels, n,
                                                    180 + n_levels)
    if not n_levels:
        # the wrapper refuses a meta with no level, as the reference does;
        # the C entry, handed one, zeroes dx
        with pytest.raises(ValueError, match="at least one level"):
            B4.brick4_nablas(g, x, table, meta)
        assert not _zero_level_entry("brick4_dydx", x).any()
        return
    dxs = []
    for xx, gg in ((x, g), (x[perm].contiguous(), g[perm].contiguous())):
        before = _build.LAUNCHES["brick4_dydx"]
        with torch.no_grad():
            dx = B4.brick4_nablas(gg, xx, table, meta)
        torch.cuda.synchronize()
        assert _build.LAUNCHES["brick4_dydx"] == before + 1
        assert dx.shape == (n, 3)
        _close(dx, B4.brick4_nablas_xla(gg, xx, table, meta), 1e-4)
        dxs.append(dx)
    assert torch.equal(dxs[1], dxs[0][perm])


def test_brick4_zero_levels(cuda):
    """An F=4 meta with no level: the wrappers refuse it (`c_meta`), as the
    JAX reference and the plain versions do; the C entries, handed one
    (`_zero_level_entry`), write no y and give B2, B3 and B4 a dL/dx of
    zeros without touching the table gradient's memory."""
    meta, x, table, g, gg, _ = _brick4_ray_inputs(cuda, 0, 100, 190)
    packed = B4.pack_table4(table)
    for call in (lambda: B4._fwd_cuda(x, packed, meta),
                 lambda: B4._fwd_cuda(x, packed, meta, want_g=True),
                 lambda: B4._bwd_cuda(x, g, meta, need_dx=True,
                                      packed=packed),
                 lambda: B4._bwd2_cuda(g, x, packed, gg, meta)):
        with pytest.raises(ValueError, match="at least one level"):
            call()
    for entry in ("brick4_fwd", "brick4_bwd", "brick4_bwd2", "brick4_dydx"):
        dx = _zero_level_entry(entry, x)
        assert entry == "brick4_fwd" or not dx.any()


# ------------- the backward and nablas entries at a meta with no level
def _zero_level_entry(entry: str, x: torch.Tensor) -> torch.Tensor:
    """Call a C entry with a meta of no level (n_dims 3 for the cell
    permuto), a dL/dx of NaNs, and 4 rows of NaNs where its table
    gradient would be (a memset sized from the level before the meta's
    first would reach them, or beyond); asserts the entry returned 0 and
    left those rows alone, and returns dL/dx (dx for a forward)."""
    dev, n = x.device, x.shape[0]
    lib = {"brick": B._lib, "brick4": B4._lib, "permuto": PC._lib,
           "permuto4": P4._lib}[entry.split("_")[0]]()
    meta = {"brick": B._Meta, "brick4": B4._Meta, "permuto": PC._Meta,
            "permuto4": PC._Meta}[entry.split("_")[0]]()
    if entry.startswith("permuto"):
        meta.n_dims, meta.cells_per_row = 3, 4
    dx = torch.full((n, 3), float("nan"), device=dev)
    dtab = torch.full((4, 256), float("nan"), device=dev)
    table = torch.zeros((4, 256), device=dev)
    empty = torch.empty((n, 0), device=dev)
    gg = torch.zeros((n, 3), device=dev)
    bidx = torch.zeros((n,), dtype=torch.int32, device=dev)
    st = _build.stream_ptr(dev)
    p = (x.data_ptr(), empty.data_ptr(), table.data_ptr(), dtab.data_ptr(),
         dx.data_ptr(), gg.data_ptr(), bidx.data_ptr())
    xp, gp, tp, dtp, dxp, ggp, bp = p
    args = {
        "brick_bwd": (xp, gp, None, tp, None, 1, meta, dtp, dxp, n, st),
        "brick_bwd_b": (xp, gp, None, tp, bp, 2, meta, dtp, dxp, n, st),
        "brick4_bwd": (xp, gp, None, tp, meta, dtp, dxp, n, st),
        "brick_bwd2": (gp, xp, tp, ggp, None, 1, meta, gp, dtp, dxp, n, st),
        "brick_bwd2_b": (gp, xp, tp, ggp, bp, 2, meta, gp, dtp, dxp, n, st),
        "brick4_bwd2": (gp, xp, tp, ggp, meta, gp, dtp, dxp, n, st),
        "brick_dydx": (gp, xp, tp, None, meta, dxp, n, st),
        "brick4_dydx": (gp, xp, tp, meta, dxp, n, st),
        "brick4_fwd": (xp, tp, meta, gp, None, n, st),
        "permuto_bwd": (xp, gp, tp, meta, dtp, dxp, n, st),
        "permuto4_bwd": (xp, gp, tp, meta, dtp, dxp, n, st),
    }[entry]
    assert getattr(lib, entry.removesuffix("_b"))(*args) == 0
    torch.cuda.synchronize()
    assert torch.isnan(dtab).all()
    return dx


@pytest.mark.parametrize("entry", ["brick_bwd", "brick_bwd_b", "brick_bwd2",
                                   "brick_bwd2_b", "brick_dydx",
                                   "permuto_bwd", "permuto4_bwd"])
@pytest.mark.parametrize("n", [1, 100_000])
def test_backward_entries_at_zero_levels(cuda, entry, n):
    """B7, B9 (both also in their forest forms, `_b`: a bidx and a table of
    two blocks) (and B8), B11/B12 and B15 at a meta with no level, through
    their C entries: no read of the level before the meta's first (the
    table gradient's memset is skipped: the rows it would have sized
    keep their NaNs) and dL/dx zeroed, not left unwritten. The wrappers
    refuse such a meta, as the JAX reference and the plain versions do."""
    x = torch.rand((n, 3), device=cuda)
    assert not _zero_level_entry(entry, x).any()
    if entry.startswith("brick"):
        empty = B.make_brick_meta([], [], 64)
        with pytest.raises(ValueError, match="at least one level"):
            B.brick_nablas(torch.empty((n, 0), device=cuda), x,
                           torch.empty((0, 128), device=cuda), empty)
    else:
        empty = PC.make_permuto_cell_meta(3, [], 64)
        with pytest.raises(ValueError, match="at least one level"):
            PC.c_meta(empty)


# ------------------------- B6 and B8 with a block row offset (the forest)
def _forest_inputs(dev, meta_name: str, n: int, blocks: int, seed: int):
    meta, x, _, g, _ = _f2_inputs(dev, meta_name, n, seed)
    rng = np.random.default_rng(seed + 1)
    table = torch.from_numpy(rng.uniform(
        -0.1, 0.1, (blocks * meta.total_rows, 128)).astype(np.float32)
        ).to(dev)
    bidx = torch.from_numpy(rng.integers(-1, blocks, n).astype(np.int32)
                            ).to(dev)
    return meta, x, table, g, bidx


@pytest.mark.parametrize("meta_name,n", F2_CASES)
def test_brick_fwd_b_and_dydx_b_match_plain(cuda, meta_name, n):
    """The forest forms of B6 and B8 (`brick_fwd_b`, `brick_dydx_b`) at
    random block indices, −1 included (it reads block 0): y within 1e-5
    and dx within 1e-4 of `brick_encode_xla_batched` and
    `brick_nablas_xla_batched`; one launch counted a call under the
    forest keys. With every bidx 0 on a one-block table both forms give
    the bits of the null-bidx entries."""
    meta, x, table, g, bidx = _forest_inputs(cuda, meta_name, n, 5, 31)
    before = dict(_build.LAUNCHES)
    with torch.no_grad():
        y = B.brick_encode_batched(x, table, meta, bidx)
        dx = B.brick_nablas_batched(g, x, table, meta, bidx)
    torch.cuda.synchronize()
    for key in ("brick_fwd_b", "brick_dydx_b"):
        assert _build.LAUNCHES[key] == before.get(key, 0) + 1
    assert _build.LAUNCHES["brick_fwd"] == before.get("brick_fwd", 0)
    assert _build.LAUNCHES["brick_dydx"] == before.get("brick_dydx", 0)
    _close(y, B.brick_encode_xla_batched(x, table, meta, bidx), 1e-5)
    _close(dx, B.brick_nablas_xla_batched(g, x, table, meta, bidx), 1e-4)
    one = table[:meta.total_rows].contiguous()
    zero = torch.zeros_like(bidx)
    assert torch.equal(B._fwd_cuda(x, one, meta, bidx=zero),
                       B._fwd_cuda(x, one, meta))
    assert torch.equal(B._dydx_cuda(g, x, one, meta, bidx=zero),
                       B._dydx_cuda(g, x, one, meta))
    # the forest form has no want_g: the entry refuses both together
    corners = torch.empty((n, meta.n_levels, 8, 2), device=cuda)
    assert B._lib().brick_fwd(
        x.data_ptr(), table.data_ptr(), bidx.data_ptr(), B.c_meta(meta),
        y.data_ptr(), corners.data_ptr(), n, _build.stream_ptr(cuda)) != 0


def test_brick_fwd_b_rows_beyond_int32_slots(cuda):
    """A block whose rows start past 2^25 rows of a `torch.empty` forest
    table (so past 2^31 float2 slots): only that block is filled, and the
    forest forms of B6 and B8 read it, equal to the plain versions on the
    block alone (the 64-bit row arithmetic)."""
    meta, x, small, g, _ = _f2_inputs(cuda, "dense_hash", 4096, 41)
    b = (1 << 25) // meta.total_rows + 2
    assert b * meta.total_rows * 64 >= 1 << 31
    table = torch.empty(((b + 1) * meta.total_rows, 128), device=cuda)
    table[b * meta.total_rows:] = small
    bidx = torch.full((x.shape[0],), b, dtype=torch.int32, device=cuda)
    with torch.no_grad():
        y = B.brick_encode_batched(x, table, meta, bidx)
        dx = B.brick_nablas_batched(g, x, table, meta, bidx)
    torch.cuda.synchronize()
    del table
    _close(y, B.brick_encode_xla(x, small, meta), 1e-5)
    _close(dx, B.brick_nablas_xla(g, x, small, meta), 1e-4)


# ------------------------- B7 and B9 with a block row offset (the forest)
@pytest.mark.parametrize("meta_name,n", F2_CASES)
@pytest.mark.parametrize("need_dx", [False, True])
def test_brick_bwd_b_and_bwd2_b_match_plain(cuda, meta_name, n, need_dx):
    """The forest forms of B7 and B9 (`brick_bwd_b`, `brick_bwd2_b`) at
    random block indices, −1 included (block 0): dL/dtable over the
    whole [5·total_rows, 128] table within 1e-5 of its largest entry
    (atomics), dL/dx and dL/dg_up within 1e-4, against
    `brick_encode_bwd_xla_batched` and `brick_nablas_bwd_xla_batched`;
    one launch counted a call under the forest keys; and through the
    wrappers' autograd (x frozen, as on the forest train step)."""
    meta, x, table, g, bidx = _forest_inputs(cuda, meta_name, n, 5, 51)
    gg = torch.randn(n, 3, device=cuda, generator=torch.Generator(
        device=cuda).manual_seed(52))
    before = dict(_build.LAUNCHES)
    dx, dtab = B._bwd_cuda(x, g, meta, need_dx=need_dx, table=table,
                           bidx=bidx)
    dg2, dx2, dtab2 = B._bwd2_cuda(g, x, table, gg, meta, need_dx=need_dx,
                                   bidx=bidx)
    torch.cuda.synchronize()
    for key in ("brick_bwd_b", "brick_bwd2_b"):
        assert _build.LAUNCHES[key] == before.get(key, 0) + 1
    for key in ("brick_bwd", "brick_bwd2"):
        assert _build.LAUNCHES[key] == before.get(key, 0)
    assert dtab.shape == dtab2.shape == table.shape
    dx_p, dtab_p = B.brick_encode_bwd_xla_batched(x, table, g, meta, bidx,
                                                  need_dx)
    _close(dtab, dtab_p, 1e-5)
    dg_p, dx2_p, dtab2_p = B.brick_nablas_bwd_xla_batched(g, x, table, gg,
                                                          meta, bidx)
    _close(dg2, dg_p, 1e-4)
    _close(dtab2, dtab2_p, 1e-5)
    if need_dx:
        _close(dx, dx_p, 1e-4)
        _close(dx2, dx2_p, 1e-4)
    else:
        assert dx is None and dx2 is None
    # the wrappers: B6/B7 and B8/B9 forest forms under autograd
    tab = table.clone().requires_grad_(True)
    gu = g.clone().requires_grad_(True)
    y = B.brick_encode_batched(x, tab, meta, bidx)
    nab = B.brick_nablas_batched(gu, x, tab, meta, bidx)
    t_grad, g_grad = torch.autograd.grad(
        (y * g).sum() + (nab * gg).sum(), (tab, gu))
    _close(t_grad, dtab_p + dtab2_p, 1e-5)
    _close(g_grad, dg_p, 1e-4)


@pytest.mark.parametrize("n", [33, 1000, 96 * 1001])
def test_brick_bwd_b_ray_and_permuted_order(cuda, n):
    """B7's and B9's forest forms on points along rays (each ray's points
    in one block, as the forest's samples) and on the same points
    permuted: dL/dx (B7 reading the table) and B9's dL/dg_up and dL/dx
    the same bits in both orders and in two runs; dL/dtable within the
    atomics' tolerance of each other."""
    meta, x, table, g, _ = _forest_inputs(cuda, "dense_hash", n, 7, 53)
    x, _ = torch.sort(x, 0)
    bidx = (torch.arange(n, device=cuda, dtype=torch.int32) // 96) % 7
    gg = torch.randn(n, 3, device=cuda, generator=torch.Generator(
        device=cuda).manual_seed(54))
    perm = torch.randperm(n, device=cuda, generator=torch.Generator(
        device=cuda).manual_seed(55))
    outs = []
    for xx, gx, gy, bb in ((x, g, gg, bidx),
                           tuple(t[perm].contiguous()
                                 for t in (x, g, gg, bidx))):
        runs = []
        for _ in range(2):
            dx, dtab = B._bwd_cuda(xx, gx, meta, need_dx=True, table=table,
                                   bidx=bb)
            dg2, dx2, dtab2 = B._bwd2_cuda(gx, xx, table, gy, meta, bidx=bb)
            runs.append((dx, dg2, dx2, dtab, dtab2))
        for a, b in zip(runs[0][:3], runs[1][:3]):
            assert torch.equal(a, b)
        outs.append(runs[0])
    (dx, dg2, dx2, dtab, dtab2), (pdx, pdg2, pdx2, pdtab, pdtab2) = outs
    assert torch.equal(pdx, dx[perm])
    assert torch.equal(pdg2, dg2[perm])
    assert torch.equal(pdx2, dx2[perm])
    _close(pdtab, dtab, 1e-5)
    _close(pdtab2, dtab2, 1e-5)


def test_brick_bwd_b_warp_shares_local_slot_across_blocks(cuda):
    """One warp's 32 lanes at one point, so one block-local slot at every
    level, in 4 blocks by lane (bidx = lane % 4): the warps' sums must
    keep the blocks apart (they key on the 64-bit global slot), so each
    block's dL/dtable holds its own 8 lanes' sum, as the plain version
    gives; summed on the block-local slot, all 32 would land in one
    block."""
    meta, x, table, g, _ = _forest_inputs(cuda, "dense_hash", 32, 4, 56)
    x = x[:1].expand(32, 3).contiguous()
    bidx = torch.arange(32, device=cuda, dtype=torch.int32) % 4
    gg = torch.randn(32, 3, device=cuda)
    _, dtab = B._bwd_cuda(x, g, meta, need_dx=False, table=table, bidx=bidx)
    _, _, dtab2 = B._bwd2_cuda(g, x, table, gg, meta, need_dx=False,
                               bidx=bidx)
    _, dtab_p = B.brick_encode_bwd_xla_batched(x, table, g, meta, bidx,
                                               False)
    _, _, dtab2_p = B.brick_nablas_bwd_xla_batched(g, x, table, gg, meta,
                                                   bidx)
    _close(dtab, dtab_p, 1e-5)
    _close(dtab2, dtab2_p, 1e-5)
    rows = meta.total_rows
    for blk in range(4):
        assert dtab[blk * rows:(blk + 1) * rows].abs().sum() > 0
    assert B.brick_atomic_groups(x, meta, bidx) == [4 * 8] * meta.n_levels
    assert B.brick_atomic_groups(x, meta) == [8] * meta.n_levels


def test_brick_bwd_b_one_block_matches_null_bidx(cuda):
    """Every bidx 0 on a one-block table: B7's dL/dx (from the table) and
    B9's dL/dg_up and dL/dx the bits of the null-bidx entries, dL/dtable
    within the atomics' tolerance; the entries refuse bidx with corners
    and, without bidx, a table of more than one block."""
    meta, x, table, g, gg = _f2_inputs(cuda, "eight_levels", 100_000, 57)
    zero = torch.zeros(x.shape[0], dtype=torch.int32, device=cuda)
    dx_b, dtab_b = B._bwd_cuda(x, g, meta, need_dx=True, table=table,
                               bidx=zero)
    dx_n, dtab_n = B._bwd_cuda(x, g, meta, need_dx=True, table=table)
    assert torch.equal(dx_b, dx_n)
    _close(dtab_b, dtab_n, 1e-5)
    got = B._bwd2_cuda(g, x, table, gg, meta, bidx=zero)
    want = B._bwd2_cuda(g, x, table, gg, meta)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    _close(got[2], want[2], 1e-5)
    corners = B._fwd_cuda(x, table, meta, want_g=True)[1]
    st, cm, n = _build.stream_ptr(cuda), B.c_meta(meta), x.shape[0]
    dx = torch.empty_like(x)
    assert B._lib().brick_bwd(
        x.data_ptr(), g.data_ptr(), corners.data_ptr(), table.data_ptr(),
        zero.data_ptr(), 1, cm, dtab_b.data_ptr(), dx.data_ptr(), n,
        st) != 0
    assert B._lib().brick_bwd(
        x.data_ptr(), g.data_ptr(), None, table.data_ptr(), None, 2, cm,
        dtab_b.data_ptr(), dx.data_ptr(), n, st) != 0
    assert B._lib().brick_bwd2(
        g.data_ptr(), x.data_ptr(), table.data_ptr(), gg.data_ptr(), None,
        2, cm, g.data_ptr(), dtab_b.data_ptr(), dx.data_ptr(), n, st) != 0
    with pytest.raises(ValueError, match="corners"):
        B._bwd_cuda(x, g, meta, need_dx=True, corners=corners, table=table,
                    bidx=zero)


def test_brick_bwd_b_rows_beyond_int32_slots(cuda):
    """A block whose rows start past 2^25 rows of the forest table (past
    2^31 float2 slots): B7's and B9's forest forms scatter into that
    block alone, equal to the null-bidx plain versions on the block
    alone, and leave every row before it zero (the 64-bit slot; the
    memset covers all blocks)."""
    meta, x, small, g, gg = _f2_inputs(cuda, "dense_hash", 4096, 58)
    b = (1 << 25) // meta.total_rows + 2
    rows = meta.total_rows
    assert b * rows * 64 >= 1 << 31
    table = torch.empty(((b + 1) * rows, 128), device=cuda)
    table[b * rows:] = small
    bidx = torch.full((x.shape[0],), b, dtype=torch.int32, device=cuda)
    dx, dtab = B._bwd_cuda(x, g, meta, need_dx=True, table=table, bidx=bidx)
    assert dtab.shape == table.shape
    assert not bool(dtab[:b * rows].count_nonzero())
    got = dtab[b * rows:].clone()
    del dtab
    dx_p, dtab_p = B.brick_encode_bwd_xla(x, small, g, meta, True)
    _close(got, dtab_p, 1e-5)
    _close(dx, dx_p, 1e-4)
    dg2, dx2, dtab2 = B._bwd2_cuda(g, x, table, gg, meta, bidx=bidx)
    del table
    assert not bool(dtab2[:b * rows].count_nonzero())
    got2 = dtab2[b * rows:].clone()
    del dtab2
    dg_p, dx2_p, dtab2_p = B.brick_nablas_bwd_xla(g, x, small, gg, meta)
    _close(got2, dtab2_p, 1e-5)
    _close(dg2, dg_p, 1e-4)
    _close(dx2, dx2_p, 1e-4)


# ---------------------------- B5: every tail, views, clamps, shapes
@pytest.mark.parametrize("n", [0, 1, 3, 5, 393_217])
def test_gather1d_tails_views_and_clamps(cuda, n):
    """B5 bitwise equal to `gather_rows_lanes_plain` at n = 0, 1, 3, 5 and
    393,217 (every length mod 4), on indices out of range at both ends
    (the flat index clamped into the table, as the plain version's take)
    and on `row[1:]` and `lane[1:]` views (4 bytes off their storage);
    one launch counted a call."""
    rng = np.random.default_rng(n + 3)
    values = torch.from_numpy(rng.standard_normal((4096, 64))
                              .astype(np.float32)).to(cuda)
    row = torch.from_numpy(rng.integers(-3, 4100, n + 1)
                           .astype(np.int32)).to(cuda)
    lane = torch.from_numpy(rng.integers(-70, 140, n + 1)
                            .astype(np.int32)).to(cuda)
    for r, c in ((row[:n], lane[:n]), (row[1:], lane[1:])):
        before = _build.LAUNCHES["gather1d"]
        out = G.gather_rows_lanes(values, r, c)
        torch.cuda.synchronize()
        assert _build.LAUNCHES["gather1d"] == before + 1
        assert out.shape == (n,) and out.dtype == torch.float32
        assert torch.equal(out, G.gather_rows_lanes_plain(values, r, c))


def test_gather1d_keeps_nd_shape(cuda):
    """B5 on [3, 7, 5] index arrays with entries clamped at both ends of
    the table: the output keeps the shape and equals the plain version."""
    rng = np.random.default_rng(7)
    values = torch.from_numpy(rng.standard_normal((256, 64))
                              .astype(np.float32)).to(cuda)
    row = rng.integers(0, 256, (3, 7, 5)).astype(np.int32)
    lane = rng.integers(0, 64, (3, 7, 5)).astype(np.int32)
    row[0, 0, :4], lane[0, 0, :4] = [-1, 300, 255, 0], [0, 70, 63, -5]
    row, lane = torch.from_numpy(row).to(cuda), torch.from_numpy(lane).to(cuda)
    out = G.gather_rows_lanes(values, row, lane)
    assert out.shape == (3, 7, 5)
    want = G.gather_rows_lanes_plain(values, row, lane)
    assert torch.equal(out, want)
    assert out[0, 0, 0] == values[0, 0] and out[0, 0, 1] == values[-1, -1]


# ------------------------------------------- the classic permuto lattice
@pytest.mark.parametrize("d,res", [(3, [2.0, 8.0, 24.0, 64.0]),
                                   (4, [8.0, 16.0, 32.0, 64.0, 128.0])],
                         ids=["3d", "4d_default"])
def test_classic_lattice_cuda_matches_cpu(cuda, d, res):
    """The classic lattice is plain PyTorch on any device (the JAX package
    computes it in XLA): on CUDA the simplex keys and hash indices are the
    CPU's bits, the values, dL/dx, dL/dtable and the table gradient of the
    nablas' squared norm (second order) within 1e-5 of each one's largest
    entry (the table gradients are sums by atomics on the card); no kernel
    of the port launches."""
    from nr3d_lib_tpu_torch.ops import permuto as P

    meta = P.make_permuto_meta(d, res, 2, 17)
    rng = np.random.default_rng(d)
    n = 100_000
    x = rng.uniform(0.0, 1.0, (n, d)).astype(np.float32)
    x[:64] = np.round(x[:64] * 8.0) / 8.0
    params = rng.uniform(-0.1, 0.1, meta.n_params).astype(np.float32)
    g = rng.standard_normal((n, meta.out_features)).astype(np.float32)
    scaled = x * np.float32(res[-1])
    kc, _ = P._simplex(torch.from_numpy(scaled), d)
    kg, _ = P._simplex(torch.from_numpy(scaled).to(cuda), d)
    assert torch.equal(kg.cpu(), kc)
    assert torch.equal(P._hash_keys(kg, 2 ** 17).cpu(),
                       P._hash_keys(kc, 2 ** 17))

    def run(dev):
        xt = torch.from_numpy(x).to(dev).requires_grad_(True)
        pt = torch.from_numpy(params).to(dev).requires_grad_(True)
        y = P.permuto_encode(xt, pt, meta)
        dx, dp = torch.autograd.grad(y, (xt, pt), torch.from_numpy(g).to(dev),
                                     create_graph=True)
        (d2p,) = torch.autograd.grad((dx ** 2).sum(), pt)
        return [t.detach().cpu() for t in (y, dx, dp, d2p)]

    before = dict(_build.LAUNCHES)
    got = run(cuda)
    torch.cuda.synchronize()
    assert dict(_build.LAUNCHES) == before
    for name, a, b in zip(("y", "dx", "dtable", "d2table"), got, run("cpu")):
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=1e-5 * float(b.abs().max()),
                                   msg=name)


def test_sphere_trace_fixed_count_matches_early_exit(cuda):
    """The trace on the card, seeded from an occupancy grid (B5): the loop
    that tests for a live ray before every iteration (JAX's early exit),
    every 8 iterations, and never (all max_iters) give the same t and
    status bit for bit. An analytic sphere, where every ray ends before
    max_iters, so the early exit stops first; then a pretrained F=4 brick
    NeuS, where each iteration and the final query launch B1 once and
    the seeding B5 once (its grazing rays keep the loop to max_iters)."""
    from nr3d_lib_tpu_torch.graphics.sphere_trace import sphere_trace
    from nr3d_lib_tpu_torch.models.fields.sdf import pretrain_sdf_sphere
    from nr3d_lib_tpu_torch.models.model_base import LoTDNeuSModel

    rng = np.random.default_rng(3)
    o = rng.normal(size=(4096, 3))
    o = o / np.linalg.norm(o, axis=-1, keepdims=True) * 2.0
    d = -o / 2.0 + rng.normal(size=(4096, 3)) * 0.05
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    d[:64] = -d[:64]                     # 64 rays leave the box: OUT
    res = 32
    centers = (np.stack(np.meshgrid(*([np.arange(res)] * 3),
                                    indexing="ij"), -1) + 0.5) / res * 2 - 1
    occ = torch.from_numpy(
        np.abs(np.linalg.norm(centers, axis=-1) - 0.5) < 0.2).to(cuda)

    def traces(o_n, d_n, near, far, sdf, occ_grid, per_iter):
        outs = {}
        with torch.no_grad():
            for k in (1, 8, 0):
                before = dict(_build.LAUNCHES)
                outs[k] = sphere_trace(o_n, d_n, near, far, sdf,
                                       occ_grid=occ_grid, check_every=k)
                torch.cuda.synchronize()
                got = {n: _build.LAUNCHES[n] - before.get(n, 0)
                       for n in _build.LAUNCHES
                       if _build.LAUNCHES[n] != before.get(n, 0)}
                want = {"gather1d": 1}
                if per_iter:
                    want[per_iter] = outs[k]["iters"] + 1
                assert got == want, (k, got)
        n = outs[1]["iters"]
        assert outs[0]["iters"] == 64
        assert outs[8]["iters"] == min(-(-n // 8) * 8, 64)
        assert float(outs[1]["hit"].float().mean()) > 0.5
        assert int((outs[1]["status"] == 2).sum()) >= 64
        for k in (8, 0):
            assert torch.equal(outs[k]["t"], outs[1]["t"])
            assert torch.equal(outs[k]["status"], outs[1]["status"])
        return n

    o_t = torch.from_numpy(o.astype(np.float32)).to(cuda)
    d_t = torch.from_numpy(d.astype(np.float32)).to(cuda)
    near = torch.zeros(4096, device=cuda)
    far = torch.full((4096,), 4.0, device=cuda)
    n = traces(o_t, d_t, near, far,
               lambda x: torch.linalg.norm(x, dim=-1) - 0.5, occ, None)
    assert 0 < n < 64

    model = LoTDNeuSModel(field_cfg={"surface_cfg": {"encoding_cfg": {
        "lotd_cfg": {"lod_res": [16, 64], "lod_n_feats": 4,
                     "lod_types": ["Dense", "Hash"]}, "backend": "brick"},
        "decoder_cfg": {"D": 1, "W": 64}}},
        accel_cfg={"resolution": 32}, device=cuda)
    pretrain_sdf_sphere(model.field.implicit_surface,
                        torch.Generator(cuda).manual_seed(0), radius=0.5,
                        n_iters=200)
    model.populate()
    rt = model.ray_test(o_t, d_t)
    o_n, d_n = model.space.normalize_rays(rt["rays_o"], rt["rays_d"])
    traces(o_n, d_n, rt["near"], rt["far"],
           lambda x: model.forward_sdf(x)["sdf"], model.accel.occ.occ(),
           "brick4_fwd")


# ----------------------- the conditional and dynamic families' paths
def test_emernerf_render_b5_lookups_match_plain(cuda):
    """examples/train_dynamic_scene.py's EmerNeRF: the render's two
    occupancy lookups through B5, bitwise the plain take, and exactly two
    launches a render."""
    from nr3d_lib_tpu_torch.models.model_families import EmerNeRFModel
    from nr3d_lib_tpu_torch.ops import occgrid_march as OM

    model = EmerNeRFModel(field_cfg={"static_cfg": {"lotd_cfg": {
        "lod_res": [16, 32, 64], "lod_n_feats": 2,
        "lod_types": ["Dense", "Dense", "Hash"], "hashmap_size": 2 ** 15}},
        "dynamic_permuto_cfg": {"res_list": [8.0, 16.0, 32.0],
                                "log2_hashmap_size": 15}},
        accel_cfg={"resolution": (16, 16, 16)}, n_time_keys=8,
        n_march_steps=64, device=cuda)
    rng = np.random.default_rng(40)
    with torch.no_grad():
        model.accel.static.val_grid.copy_(torch.from_numpy(
            rng.uniform(size=(16,) * 3).astype(np.float32) * 0.02))
        model.accel.dynamic.occ.val_grid.copy_(torch.from_numpy(
            rng.uniform(size=(8, 16, 16, 16)).astype(np.float32) * 0.012))
    o = rng.normal(size=(2048, 3))
    o = o / np.linalg.norm(o, axis=-1, keepdims=True) * 2.0
    d = rng.uniform(-0.3, 0.3, (2048, 3)) - o
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    o, d = (torch.from_numpy(a.astype(np.float32)).to(cuda) for a in (o, d))
    rt = model.ray_test(o, d)
    rt["ts"] = torch.from_numpy(rng.uniform(-1, 1, 2048).astype(
        np.float32)).to(cuda)
    o_n, d_n = model.space.normalize_rays(o, d)
    t, _, _ = OM.march_steps(rt["near"], rt["far"], 64, 2.0 / 64)
    xs = [o_n[:, None, a] + d_n[:, None, a] * t for a in range(3)]
    row, lane, _ = OM.grid_rows_lanes((16, 16, 16), *xs)
    for grid in (model.accel.static.occ(),
                 torch.any(model.accel.dynamic.occ.occ(), 0)):
        values = grid.reshape(256, 16).to(torch.float32)
        assert 0.05 < float(values.mean()) < 0.95
        assert torch.equal(G.gather_rows_lanes(values, row, lane),
                           G.gather_rows_lanes_plain(values, row, lane))
    _build.LAUNCHES.clear()
    with torch.no_grad():
        rendered, _ = model.ray_query(rt)
    torch.cuda.synchronize()
    assert dict(_build.LAUNCHES) == {"gather1d": 2}
    assert bool(torch.isfinite(rendered["rgb_volume"]).all())


def test_generative_cell_path_matches_cpu_route(cuda):
    """The d = 5 generative field on the cell layout. On the lattice inputs
    the field builds on the card ([x, tanh(z)], 50,000 points): B10 and
    B13 against their plain versions on those same inputs (1e-5, 1e-4 of
    the largest entry). The field's split nablas against the CPU route's
    given the card's lattice inputs: within 1e-4 of the largest entry at
    every point. Against the CPU route from x and z alone: the same
    wherever the two devices build the same lattice input bits (at least
    half of the points; 73% on an H100, whose tanh rounds the latent an
    ulp away from the CPU's on the rest). There a point near a simplex
    face may change simplex, and the piecewise-linear gradient jumps, so
    99.9% of the points are required. 4 B10 + 1 B13 a render of the
    batched model."""
    from nr3d_lib_tpu_torch.models.model_families import \
        GenerativePermutoNeuSModelBatched

    cfg = dict(n_instances=4, latent_dim=2, latent_std=0.1, field_cfg={
        "surface_cfg": {"permuto_cfg": {"res_list": [8.0, 16.0, 32.0, 64.0],
                                        "backend": "cell"},
                        "decoder_cfg": {"D": 1, "W": 64}},
        "radiance_cfg": {"D": 2, "W": 64}},
        ray_query_cfg={"n_coarse": 32, "upsample_inv_s_factors": [1.0, 4.0],
                       "n_importance": 8})
    model = GenerativePermutoNeuSModelBatched(**cfg, device=cuda)
    cpu = GenerativePermutoNeuSModelBatched(**cfg, device="cpu")
    rng = np.random.default_rng(41)
    with torch.no_grad():
        p = model.field.implicit_surface.bank.flattened_params
        p.copy_(torch.from_numpy(rng.uniform(-0.1, 0.1, tuple(p.shape))
                                 .astype(np.float32)))
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    x = torch.from_numpy(rng.uniform(-1, 1, (50_000, 3)).astype(np.float32))
    z = torch.from_numpy(rng.normal(0, 0.3, (50_000, 2)).astype(np.float32))
    surf, surf_cpu = model.field.implicit_surface, cpu.field.implicit_surface
    bank, meta = surf.bank, surf.bank.meta
    table = bank.flattened_params.detach()
    with torch.no_grad():
        inp = surf._inp(x.to(cuda), z.to(cuda))
        g = torch.randn(50_000, 2 * meta.n_levels, device=cuda,
                        generator=torch.Generator(cuda).manual_seed(42))
        _build.LAUNCHES.clear()
        y, nab = bank.encode(inp), bank.nablas(g, inp)
        torch.cuda.synchronize()
        assert dict(_build.LAUNCHES) == {"permuto_fwd": 1, "permuto_dydx": 1}
        _close(y, PC.permuto_cell_encode_xla(inp, table, meta), 1e-5)
        _close(nab, PC.permuto_cell_nablas_xla(g, inp, table, meta), 1e-4)
        got = surf.forward_sdf_nablas(x.to(cuda), z.to(cuda))
        want = surf_cpu.forward_sdf_nablas(x, z)
        zz = inp[:, 3:].cpu()
        want_card_inp = surf_cpu._sdf_nablas(
            x, lambda xx: torch.cat([xx * 0.5 + 0.5, zz], -1))
        same = (inp.cpu() == surf_cpu._inp(x, z)).all(-1)
    for k in ("sdf", "h", "nablas"):
        _close(got[k].cpu(), want_card_inp[k], 1e-4)
    share_same = float(same.float().mean())
    print(f"points whose lattice inputs have the same bits on both "
          f"devices: {share_same:.6f}")
    assert share_same >= 0.5, share_same
    ok = torch.ones(50_000, dtype=torch.bool)
    for k in ("sdf", "h", "nablas"):
        a = got[k].cpu().reshape(50_000, -1)
        b = want[k].reshape(50_000, -1)
        tol = 1e-4 * float(b.abs().max()) + 1e-7
        ok &= ((a - b).abs() <= tol).all(-1)
    assert bool(ok[same].all())
    assert float(ok.float().mean()) >= 0.999
    o = torch.from_numpy(rng.normal(size=(1024, 3)).astype(np.float32))
    o = o / o.norm(dim=-1, keepdim=True) * 2.0
    rt = model.ray_test(o.to(cuda), (-o / 2.0).to(cuda))
    rt["bidx"] = torch.from_numpy(rng.integers(0, 4, 1024)).to(cuda)
    _build.LAUNCHES.clear()
    with torch.no_grad():
        model.ray_query(rt)
    torch.cuda.synchronize()
    assert dict(_build.LAUNCHES) == {"permuto_fwd": 4, "permuto_dydx": 1}


@pytest.mark.parametrize("n_feats", [2, 4], ids=["F2", "F4"])
def test_cell_encode_ho_cuda_matches_cpu(cuda, n_feats):
    from nr3d_lib_tpu_torch.models.grid_encodings.permuto import \
        PermutoParams

    kw = dict(n_feats=n_feats, backend="cell", hashmap_rows=2048)
    bank = PermutoParams(4, [4.0, 11.0, 23.0], **kw, device=cuda)
    cpu = PermutoParams(4, [4.0, 11.0, 23.0], **kw, device="cpu")
    rng = np.random.default_rng(51)
    table = rng.uniform(-0.1, 0.1, tuple(cpu.flattened_params.shape))
    x_np = rng.uniform(0.0, 1.0, (4096, 4)).astype(np.float32)
    w_np = rng.normal(size=(4096, cpu.out_features)).astype(np.float32)
    outs = []
    for m, dev in ((bank, cuda), (cpu, torch.device("cpu"))):
        with torch.no_grad():
            m.flattened_params.copy_(torch.from_numpy(
                table.astype(np.float32)))
        x = torch.from_numpy(x_np).to(dev).requires_grad_(True)
        _build.LAUNCHES.clear()
        y = m.encode(x, ho=True)
        (gx,) = torch.autograd.grad((y * torch.from_numpy(w_np).to(dev))
                                    .sum(), x, create_graph=True)
        (gt,) = torch.autograd.grad((gx ** 2).sum(), m.flattened_params)
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert not dict(_build.LAUNCHES)
        outs.append([t.detach().cpu() for t in (y, gx, gt)])
    _close(outs[0][0], outs[1][0], 1e-5)
    for a, b in zip(outs[0][1:], outs[1][1:]):
        _close(a, b, 1e-4)


def test_chamfer_cuda_matches_cpu(cuda):
    from nr3d_lib_tpu_torch.maths.knn import chamfer_distance, knn_points

    rng = np.random.default_rng(52)
    x = torch.from_numpy(rng.normal(size=(5000, 3)).astype(np.float32))
    y = torch.from_numpy(rng.normal(size=(4000, 3)).astype(np.float32))
    for squared in (True, False):
        got = chamfer_distance(x.to(cuda), y.to(cuda), squared=squared)
        want = chamfer_distance(x, y, squared=squared)
        for a, b in zip(got, want):
            assert abs(float(a) - float(b)) <= 1e-6 * abs(float(b))
    d_g, i_g = knn_points(x.to(cuda), y.to(cuda), 4)
    d_c, i_c = knn_points(x, y, 4)
    assert float((i_g.cpu() == i_c).float().mean()) >= 0.999
    _close(d_g.cpu(), d_c, 1e-5)


def _sphere_neus(dev):
    """A small classic-LoTD NeuS pretrained on the CPU to the sphere of
    radius 0.5, and its twin on the card."""
    from nr3d_lib_tpu_torch.models.fields.sdf import pretrain_sdf_sphere
    from nr3d_lib_tpu_torch.models.model_base import LoTDNeuSModel

    cfg = dict(field_cfg={"surface_cfg": {
        "encoding_cfg": {"lotd_cfg": {"lod_res": [8, 16, 32],
                                      "lod_n_feats": 2,
                                      "lod_types": ["Dense", "Dense", "Hash"],
                                      "hashmap_size": 2 ** 12}},
        "decoder_cfg": {"D": 1, "W": 32}},
        "radiance_cfg": {"D": 2, "W": 32},
        "var_ctrl_cfg": {"type": "learned", "init_val": 64.0}},
        accel_cfg={"resolution": 16, "max_steps_per_ray": 64,
                   "step_size": 2 / 32})
    cpu = LoTDNeuSModel(**cfg, device="cpu")
    pretrain_sdf_sphere(cpu.field.implicit_surface, torch.Generator(
        ).manual_seed(0), radius=0.5, n_iters=300)
    cpu.populate()
    m = LoTDNeuSModel(**cfg, device=dev)
    m.load_state_dict(cpu.state_dict())
    return m, cpu


def test_extract_mesh_and_turntable_cuda_match_cpu(cuda):
    from nr3d_lib_tpu_torch.graphics.trianglemesh import extract_mesh
    from nr3d_lib_tpu_torch.gui import render_turntable

    m, cpu = _sphere_neus(cuda)
    (vg, fg), (vc, fc) = [
        extract_mesh(lambda x, mm=mm: mm.forward_sdf(x)["sdf"],
                     resolution=40, device=mm.device) for mm in (m, cpu)]
    assert len(fc) > 100
    np.testing.assert_array_equal(fg, fc)
    np.testing.assert_allclose(vg, vc, rtol=0, atol=1e-4)
    frames = [np.stack(render_turntable(mm, n_frames=2, radius=2.5,
                                        hw=(48, 48))) for mm in (m, cpu)]
    diff = np.abs(frames[0].astype(np.int32) - frames[1].astype(np.int32))
    assert float((diff == 0).mean()) >= 0.99
    assert int(diff.max()) <= 1


# ------------------------- the occupancy getter, the MLP fields, bf16
def _getter_w4(dev):
    """examples/train_neus_object.py --w4 at a small width with the
    `use_ema=False` getter grid: pretrained on the card to the sphere of
    radius 0.5 and populated there, and its CPU twin."""
    from nr3d_lib_tpu_torch.models.fields.sdf import pretrain_sdf_sphere
    from nr3d_lib_tpu_torch.models.model_base import LoTDNeuSModel

    cfg = dict(field_cfg={"surface_cfg": {
        "encoding_cfg": {"lotd_cfg": {"lod_res": [16, 64], "lod_n_feats": 4,
                                      "lod_types": ["Dense", "Hash"],
                                      "hashmap_size": 2 ** 16},
                         "backend": "brick"},
        "decoder_cfg": {"D": 1, "W": 32}},
        "radiance_cfg": {"D": 2, "W": 32},
        "var_ctrl_cfg": {"type": "learned", "init_val": 64.0}},
        accel_cfg={"resolution": 32, "max_steps_per_ray": 96,
                   "step_size": 2 / 48, "use_ema": False},
        ray_query_cfg={"query_mode": "march_occ_multi_upsample",
                       "upsample_inv_s_factors": [1.0, 4.0],
                       "n_importance": 12})
    m = LoTDNeuSModel(**cfg, device=dev)
    pretrain_sdf_sphere(m.field.implicit_surface,
                        torch.Generator(dev).manual_seed(0), radius=0.5,
                        n_iters=200)
    m.populate()
    cpu = LoTDNeuSModel(**cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in m.state_dict().items()})
    return m, cpu


def test_getter_model_launches_and_render_match_cpu(cuda):
    """The getter grid's update (1 B1 launch for the 32,768 cell centres),
    the same grid as the CPU route's update except cells whose value lies
    within 1e-5 of the threshold; `accel.query` through B5 bitwise the
    CPU's; the render's launches (4 B1, 1 B3, 1 B5) and at least 99% of
    its rays within 1e-4 of the CPU route."""
    m, cpu = _getter_w4(cuda)
    grid = m.accel.occ.occ_grid
    assert grid.dtype == torch.bool and 0.02 < float(grid.float().mean()) < 0.9
    _build.LAUNCHES.clear()
    with torch.no_grad():
        m.training_before_per_step(16)
    torch.cuda.synchronize()
    assert dict(_build.LAUNCHES) == {"brick4_fwd": 1}
    cpu.training_before_per_step(16)
    from nr3d_lib_tpu_torch.models.accelerations.occgrid import cell_centers
    with torch.no_grad():
        v = cpu.query_occ_val(cell_centers((32, 32, 32))).reshape(32, 32, 32)
    near = (v.abs() - 0.01).abs() < 1e-5
    same = m.accel.occ.occ_grid.cpu() == cpu.accel.occ.occ_grid
    assert bool((same | near).all())
    cpu.accel.occ.occ_grid.copy_(m.accel.occ.occ_grid.cpu())
    x = torch.from_numpy(np.random.default_rng(60).uniform(
        -1.1, 1.1, (100_000, 3)).astype(np.float32))
    _build.LAUNCHES.clear()
    q = m.accel.query(x.to(cuda))
    torch.cuda.synchronize()
    assert dict(_build.LAUNCHES) == {"gather1d": 1}
    assert torch.equal(q.cpu(), cpu.accel.query(x))
    assert m.accel.debug_stats() == cpu.accel.debug_stats()
    assert m.accel.try_shrink() is None
    rng = np.random.default_rng(61)
    o = rng.normal(size=(1024, 3))
    o = o / np.linalg.norm(o, axis=-1, keepdims=True) * 2.0
    d = -o / 2.0 + rng.normal(size=(1024, 3)) * 0.1
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    o, d = (torch.from_numpy(a.astype(np.float32)) for a in (o, d))
    _build.LAUNCHES.clear()
    with torch.no_grad():
        rg, _ = m.ray_query(m.ray_test(o.to(cuda), d.to(cuda)))
        torch.cuda.synchronize()
        assert dict(_build.LAUNCHES) == {"brick4_fwd": 4, "brick4_dydx": 1,
                                         "gather1d": 1}
        rc, _ = cpu.ray_query(cpu.ray_test(o, d))
    assert float(rc["mask_volume"].mean()) > 0.1
    ok = torch.ones(1024, dtype=torch.bool)
    for k in ("rgb_volume", "depth_volume"):
        ok &= (rg[k].cpu() - rc[k]).abs().reshape(1024, -1).amax(-1) <= 1e-4
    assert float(ok.float().mean()) >= 0.99


def test_ema_collect_samples_and_shrink_cuda_match_cpu(cuda):
    """`OccGridEma.collect_samples` (a scatter-max, so order-free) and
    `try_shrink` on the card bitwise the CPU's."""
    from nr3d_lib_tpu_torch.models.accelerations import OccGridAccel

    rng = np.random.default_rng(62)
    vals = rng.uniform(0.0, 0.0105, (32, 32, 32)).astype(np.float32)
    x = rng.uniform(-1.1, 1.1, (200_000, 3)).astype(np.float32)
    v = rng.normal(scale=0.02, size=200_000).astype(np.float32)
    out = []
    for dev in (cuda, torch.device("cpu")):
        a = OccGridAccel(resolution=32, device=dev)
        a.occ.val_grid.copy_(torch.from_numpy(vals))
        a.collect_samples(torch.from_numpy(x).to(dev),
                          torch.from_numpy(v).to(dev))
        out.append((a.occ.val_grid.cpu(), a.try_shrink().cpu(),
                    float(a.occ.occupancy_ratio())))
    assert torch.equal(out[0][0], out[1][0])
    assert torch.equal(out[0][1], out[1][1])
    assert out[0][2] == out[1][2]


@pytest.mark.parametrize("kind", ["mlp_neus", "mlp_nerf", "lipshitz"])
def test_mlp_fields_cuda_match_cpu(cuda, kind):
    """The MLP-only fields at JAX's defaults on 16,384 points, no kernel
    of the port launched: values within 1e-5 + 1e-4 of the largest
    entry, a loss's gradients (through the nablas' second order for the
    NeuS) within 1e-3 relative L2 of the CPU route's."""
    from nr3d_lib_tpu_torch.models.blocks import LipshitzMLP
    from nr3d_lib_tpu_torch.models.fields import MlpNeRF, MlpNeuS

    rng = np.random.default_rng(63)
    x = torch.from_numpy(rng.uniform(-1, 1, (16384, 3)).astype(np.float32))
    v = torch.nn.functional.normalize(torch.from_numpy(
        rng.normal(size=(16384, 3)).astype(np.float32)), dim=-1)
    make = {"mlp_neus": lambda dev: MlpNeuS(seed=0, device=dev),
            "mlp_nerf": lambda dev: MlpNeRF(seed=0, device=dev),
            "lipshitz": lambda dev: LipshitzMLP(3, 4, seed=0, device=dev)}
    m, cpu = make[kind](cuda), make[kind]("cpu")
    if kind == "lipshitz":
        # off the init's clamp corner, where a last-ulp difference picks
        # the other gradient (as tests/test_torch_mlp_fields.py does)
        with torch.no_grad():
            for i, c in enumerate(m.cs):
                c.add_(-0.3 if i % 2 == 0 else 0.3)
    cpu.load_state_dict({k: t.cpu() for k, t in m.state_dict().items()})

    def outputs(mm, dev):
        xx, vv = x.to(dev), v.to(dev)
        if kind == "lipshitz":
            y = mm(xx)
            return {"y": y}, torch.mean(y ** 2)
        out = mm(xx, vv)
        loss = torch.mean(out["rgb"] ** 2)
        if kind == "mlp_neus":
            loss = loss + torch.mean((torch.linalg.norm(
                out["nablas"], dim=-1) - 1.0) ** 2)
        else:
            loss = loss + torch.mean(out["sigma"])
        return out, loss

    _build.LAUNCHES.clear()
    og, lg = outputs(m, cuda)
    lg.backward()
    torch.cuda.synchronize()
    assert dict(_build.LAUNCHES) == {}
    oc, lc = outputs(cpu, torch.device("cpu"))
    lc.backward()
    for k in oc:
        ref = oc[k].detach()
        err = float((og[k].detach().cpu() - ref).abs().max())
        assert err <= 1e-5 + 1e-4 * float(ref.abs().max()), k
    lg, lc = float(lg.detach()), float(lc.detach())
    assert abs(lg - lc) <= 1e-4 * abs(lc)
    for (k, a), b in zip(m.named_parameters(), cpu.parameters()):
        if b.grad is None:
            continue
        rel = float(torch.linalg.norm(a.grad.cpu() - b.grad) /
                    max(float(torch.linalg.norm(b.grad)), 1e-12))
        assert rel <= 1e-3, (k, rel)


def test_lotd_sdf_bf16_cuda_matches_cpu(cuda):
    """The classic-LoTD SDF with bf16 compute and parameters: bf16 sdf and
    h, float32 nablas, as on the CPU; sdf and h within two bf16 steps
    (2·2⁻⁸) of the largest entry and the nablas within four, on at least
    99% of the points (the card's bf16 matmuls accumulate in another
    order and round once more or less), no kernel of the port."""
    from nr3d_lib_tpu_torch.models.fields.sdf import LoTDSDF

    bf = {"compute_dtype": "bfloat16", "param_dtype": "bfloat16"}
    cfg = dict(encoding_cfg={"lotd_cfg": {
        "lod_res": [16, 32, 64, 128], "lod_n_feats": 2,
        "lod_types": ["Dense", "Dense", "Hash", "Hash"],
        "hashmap_size": 2 ** 16}, **bf}, decoder_cfg={"D": 1, "W": 64, **bf})
    m = LoTDSDF(**cfg, device=cuda)
    with torch.no_grad():
        p = m.encoding.flattened_params
        p.copy_(torch.from_numpy(np.random.default_rng(64).uniform(
            -0.1, 0.1, tuple(p.shape)).astype(np.float32)))
    cpu = LoTDSDF(**cfg, device="cpu")
    cpu.load_state_dict({k: t.cpu() for k, t in m.state_dict().items()})
    x = torch.from_numpy(np.random.default_rng(65).uniform(
        -1, 1, (65536, 3)).astype(np.float32))
    _build.LAUNCHES.clear()
    og = m.forward_sdf_nablas(x.to(cuda))
    torch.cuda.synchronize()
    assert dict(_build.LAUNCHES) == {}
    oc = cpu.forward_sdf_nablas(x)
    for k, steps in (("sdf", 2), ("h", 2), ("nablas", 4)):
        assert og[k].dtype == oc[k].dtype == (
            torch.float32 if k == "nablas" else torch.bfloat16)
        ref = oc[k].detach().float()
        err = (og[k].detach().cpu().float() - ref).abs().reshape(65536, -1)
        ok = err.amax(-1) <= steps * 2.0 ** -8 * float(ref.abs().max())
        assert float(ok.float().mean()) >= 0.99, k


# ------------------------------------- the ray, pack and maths layers (A14)
def test_brick4_encode_frozen_x_launches_b2_without_dx(cuda):
    meta, x, table = _inputs(cuda, 50_000, seed=23)
    table.requires_grad_(True)
    x.requires_grad_(True)
    calls, saved = [], B4._bwd_cuda

    def spy(*a, **kw):
        calls.append(kw.get("need_dx"))
        return saved(*a, **kw)

    B4._bwd_cuda = spy
    try:
        _build.LAUNCHES.clear()
        y = B4.brick4_encode_frozen_x(x, table, meta)
        g = torch.randn_like(y)
        (dtab,) = torch.autograd.grad(y, table, g)
        torch.cuda.synchronize()
    finally:
        B4._bwd_cuda = saved
    assert dict(_build.LAUNCHES) == {"brick4_fwd": 1, "brick4_bwd": 1}
    assert calls == [False]
    xc, tc = x.detach().cpu(), table.detach().cpu().requires_grad_(True)
    (want,) = torch.autograd.grad(B4.brick4_encode_xla(xc, tc, meta), tc,
                                  g.cpu())
    torch.testing.assert_close(dtab.cpu(), want, rtol=0,
                               atol=1e-5 * float(want.abs().max()))


def test_dmtet_cuda_matches_cpu(cuda):
    from nr3d_lib_tpu_torch.models.fields.sdf import LoTDSDF
    from nr3d_lib_tpu_torch.models.tetrahedral import DMTet

    cfg = dict(encoding_cfg={"lotd_cfg": {
        "lod_res": [16, 64], "lod_n_feats": 4, "lod_types": ["Dense", "Hash"],
        "hashmap_size": 2 ** 16}, "backend": "brick"},
        decoder_cfg={"D": 1, "W": 64})
    m = LoTDSDF(**cfg, device=cuda)
    with torch.no_grad():
        p = m.encoding.flattened_params
        p.copy_(torch.from_numpy(np.random.default_rng(66).uniform(
            -0.1, 0.1, tuple(p.shape)).astype(np.float32)))
    dm, dm_c = DMTet(32, device=cuda), DMTet(32, device="cpu")
    _build.LAUNCHES.clear()
    sdf = m.forward_sdf(dm.base_verts)["sdf"]
    sdf = sdf - sdf.detach().median()
    sdf.retain_grad()
    deform = torch.zeros_like(dm.base_verts).normal_(0, 0.3)
    deform.requires_grad_(True)
    tv, mask, bits = dm(sdf, deform)

    def loss(tv_, m_):
        r = torch.linalg.norm(tv_, dim=-1)
        return torch.sum(torch.where(m_[..., None], (r - 0.4) ** 2,
                                     torch.zeros_like(r)))

    loss(tv, mask).backward()
    torch.cuda.synchronize()
    assert dict(_build.LAUNCHES) == {"brick4_fwd": 1, "brick4_bwd": 1}
    s_c = sdf.detach().cpu().requires_grad_(True)
    d_c = deform.detach().cpu().requires_grad_(True)
    tv_c, mask_c, bits_c = dm_c(s_c, d_c)
    loss(tv_c, mask_c).backward()
    assert torch.equal(bits.cpu(), bits_c) and torch.equal(mask.cpu(), mask_c)
    assert 0 < int(mask.sum()) < mask.numel()
    assert float((tv.detach().cpu() - tv_c.detach()).abs().max()) <= 1e-5
    for a, b in ((sdf.grad, s_c.grad), (deform.grad, d_c.grad)):
        rel = float(torch.linalg.norm(a.cpu() - b) / torch.linalg.norm(b))
        assert rel <= 1e-4, rel


def test_pose_refinement_step_cuda_matches_cpu(cuda):
    from nr3d_lib_tpu_torch.graphics.cameras import look_at
    from nr3d_lib_tpu_torch.models.attributes import (
        OpenCVCameraIntrinsics, TransformExpSE3, TransformRT)
    from nr3d_lib_tpu_torch.models.fields.sdf import pretrain_sdf_sphere
    from nr3d_lib_tpu_torch.models.model_base import LoTDNeuSModel

    cfg = dict(
        field_cfg={"surface_cfg": {"encoding_cfg": {"lotd_cfg": {
            "lod_res": [16, 64], "lod_n_feats": 4,
            "lod_types": ["Dense", "Hash"], "hashmap_size": 2 ** 16},
            "backend": "brick"}, "decoder_cfg": {"D": 1, "W": 64}},
            "radiance_cfg": {"D": 2, "W": 64}},
        accel_cfg={"resolution": 32, "max_steps_per_ray": 96,
                   "step_size": 2 / 48},
        ray_query_cfg={"query_mode": "march_occ_multi_upsample",
                       "upsample_inv_s_factors": [1.0, 4.0],
                       "n_importance": 12})
    m = LoTDNeuSModel(**cfg, seed=0, device=cuda)
    pretrain_sdf_sphere(m.field.implicit_surface,
                        torch.Generator(cuda).manual_seed(0), radius=0.5,
                        n_iters=300)
    m.populate()
    cpu = LoTDNeuSModel(**cfg, seed=0, device="cpu")
    cpu.load_state_dict({k: t.cpu() for k, t in m.state_dict().items()})
    for mm in (m, cpu):
        for p in mm.parameters():
            p.requires_grad_(False)
    rng = np.random.default_rng(69)
    uv = np.stack([rng.uniform(0, 128, 512), rng.uniform(0, 128, 512)],
                  -1).astype(np.float32)
    c2w = look_at((0.6, 0.5, -1.85), (0.0, 0.0, 0.0), device="cpu")
    rt_c = TransformRT.from_mat4x4(c2w)
    init = {"w": np.asarray([0.6, 0.0, 0.8], np.float32),
            "v": np.asarray([0.1, -0.2, 0.3], np.float32),
            "theta": np.float32(0.02)}

    def step(dev, mm):
        def t(x):
            return torch.tensor(np.float32(x), device=dev)
        intr = OpenCVCameraIntrinsics(
            t(150.0), t(155.0), t(64.0), t(62.0), 128, 128,
            dist=torch.tensor([0.02, -0.01, 0.005, -0.003], device=dev))
        delta = TransformExpSE3(*(torch.tensor(init[k], device=dev,
                                               requires_grad=True)
                                  for k in ("w", "v", "theta")))
        rt = TransformRT(rt_c.rot.to(dev), rt_c.trans.to(dev))
        pose = delta.mat_4x4() @ rt.mat_4x4()
        d = torch.einsum("ij,nj->ni", pose[:3, :3],
                         intr.lift(torch.from_numpy(uv).to(dev)))
        d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
        o = pose[:3, 3].expand(d.shape)
        rgb = mm.ray_query(mm.ray_test(o, d))[0]["rgb_volume"]
        loss = torch.mean((rgb - 0.5) ** 2)
        loss.backward()
        return loss.detach().cpu(), [q.grad.cpu().reshape(-1) for q in
                                     delta.parameters()]

    _build.LAUNCHES.clear()
    lg, gg = step(cuda, m)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    lc, gc = step(torch.device("cpu"), cpu)
    assert launches.get("brick4_fwd_g") == 1 and \
        launches.get("brick4_bwd") == 1 and launches.get("brick4_bwd2") == 1
    assert abs(float(lg) - float(lc)) <= 1e-4 * abs(float(lc))
    got, want = torch.cat(gg), torch.cat(gc)
    assert float(want.abs().max()) > 0
    assert float(torch.linalg.norm(got - want) / torch.linalg.norm(want)) \
        <= 1e-2


def test_packed_sort_stable_on_cuda(cuda):
    from nr3d_lib_tpu_torch.graphics import pack_ops as P

    rng = np.random.default_rng(70)
    n = 393_216
    ridx = torch.from_numpy(np.sort(rng.integers(0, 4097, n)).astype(
        np.int32))
    perm = torch.from_numpy(rng.permutation(n))
    key = torch.from_numpy((rng.integers(0, 3, n) * 0.5).astype(np.float32))
    args = (key, ridx[perm], torch.arange(n))
    got = P.packed_sort(*(a.to(cuda) for a in args))
    want = P.packed_sort(*args)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    # within equal (ridx, key) the payload ascends: the sort is stable
    k, r, pay = want
    same = (k[1:] == k[:-1]) & (r[1:] == r[:-1])
    assert int(same.sum()) > n // 2 and bool((pay[1:] > pay[:-1])[same].all())


def test_ddp_neus_step_on_two_gloo_ranks_sharing_the_card(cuda, tmp_path):
    import multiprocessing as mp
    import os

    import torch_parallel_ranks as R

    _build.build_all(["brick4", "gather1d"])     # the ranks only load
    inp = R.neus_inputs(2)
    torch.save(inp, tmp_path / "inputs.pt")
    procs = [mp.get_context("spawn").Process(
        target=R.run, args=(r, 2, str(tmp_path), "cuda")) for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(300)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
    assert not alive and [p.exitcode for p in procs] == [0, 0]
    outs = [torch.load(os.path.join(tmp_path, f"rank{r}.pt"),
                       weights_only=False) for r in range(2)]
    # the reference steps on rank 0's gradients (B2's atomics): every
    # step's loss and gradients are held on the ranks' own state
    losses, grads, params = R.neus_reference(inp, cuda,
                                             forced=outs[0]["neus_grads"])
    for out in outs:
        torch.testing.assert_close(out["neus_losses"], losses.cpu(),
                                   rtol=1e-6, atol=0)
        for got, want in zip(out["neus_grads"], grads):
            assert set(got) == set(want)
            for k, g in want.items():
                assert float((got[k] - g).norm() / g.norm()) <= 1e-5, k
        for k, p in params.items():
            err = (out["neus_params"][k] - p.cpu()).norm() / p.norm().cpu()
            assert float(err) <= 1e-4, k
    for k, p in outs[0]["neus_params"].items():
        assert torch.equal(p, outs[1]["neus_params"][k]), k
    assert torch.equal(outs[0]["neus_occ"], outs[1]["neus_occ"])


def test_loop_chunks_over_b1_is_bitwise(cuda):
    from nr3d_lib_tpu_torch.ops.chunking import loop_chunks

    meta, x, table = _inputs(cuda, 100_000, seed=71)
    with torch.no_grad():
        _build.LAUNCHES.clear()
        one = B4.brick4_encode(x, table, meta)
        (chunks,), _ = loop_chunks(
            lambda xc: ((B4.brick4_encode(xc, table, meta),), ()), (x,),
            x.shape[0], 30_000, pad_values=(0.5,))
        torch.cuda.synchronize()
    assert dict(_build.LAUNCHES) == {"brick4_fwd": 5}
    assert torch.equal(chunks, one)


def test_instantiate_lotd_nerf_w4_on_the_card(cuda):
    from pathlib import Path

    from nr3d_lib_tpu_torch.config import instantiate, load_config

    cfg = load_config(Path(__file__).resolve().parents[1] / "examples" /
                      "configs" / "lotd_nerf_w4.yaml")
    model = instantiate(cfg.model, seed=int(cfg.seed), device="cuda")
    model.populate()
    cpu = instantiate(cfg.model, seed=int(cfg.seed), device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    rng = np.random.default_rng(72)
    o = rng.normal(size=(1024, 3))
    o = o / np.linalg.norm(o, axis=-1, keepdims=True) * 2.0
    d = -o / 2.0 + rng.normal(size=(1024, 3)) * 0.1
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    o, d = (torch.from_numpy(a.astype(np.float32)) for a in (o, d))
    with torch.no_grad():
        _build.LAUNCHES.clear()
        got, _ = model.ray_query(model.ray_test(o.to(cuda), d.to(cuda)))
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
        want, _ = cpu.ray_query(cpu.ray_test(o[:256], d[:256]))
    assert type(model).__module__ == "nr3d_lib_tpu_torch.models.model_base"
    assert launches.get("brick4_fwd", 0) >= 1 and \
        launches.get("gather1d", 0) >= 1, launches
    err = (got["rgb_volume"][:256].cpu() - want["rgb_volume"]).abs().amax(-1)
    assert float((err <= 1e-4).float().mean()) >= 0.99
