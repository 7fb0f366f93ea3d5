"""Port parity: the cell permutohedral encodings against the JAX package
on the CPU — the shared geometry (`nr3d_lib_tpu_torch/ops/permuto_cell.py`)
and the plain versions of both layouts: F=2 (`ops/permuto_cell.py`, an f32
[rows, 128] table) and F=4 bf16-packed (`ops/permuto_cell4.py`, an
unpacked [rows, 256] table). Every test whose body is the same for both
takes the `case` fixture, parametrized over (F, meta); the F=4-only tests
(bf16 quantization, the yaml's meta) take `case4`.

Metas: for F=4, the 4D (x,t) meta of
`examples/configs/dynamic_permuto_w4.yaml` (res_list [4, 11, 32, 90],
4096 rows: one dense level of 1792 rows and three hashed levels); for
F=2, the dynamic NeuS field's own default 4D meta (res_list [8, 16, 32,
64, 128], 4096 rows: five hashed levels, 20,480 rows); for both, a small
3D one with 64 rows (a dense level and hashed levels that collide). The
JAX side runs on the CPU through its XLA route (`permuto_cell_encode`,
`permuto_cell4_encode` and their nablas take it there), op by op, never
in interpret mode. Inputs are float32 from numpy seeds and include lattice
ties: points on a 1/8 grid, x = 0.5 in every coordinate, equal
coordinates and the box corners.

Tolerances: the simplex search (rem0, rank, row, lane) must match exactly;
the barycentric weights to 1e-6 (measured: equal). The values, dL/dtable,
dL/dx, the nablas and the nablas' second order are sums in another order:
1e-5 relative to the largest entry. (Under `jax.jit`, XLA's CPU compiler
contracts the elevation's `tail − 3·cf` into an FMA; the op-by-op route
rounds it separately, as the port and its CUDA kernels do.)
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nr3d_lib_tpu.ops import permuto as jperm
from nr3d_lib_tpu.ops import permuto_cell as jcell
from nr3d_lib_tpu.ops import permuto_cell4 as j4
from nr3d_lib_tpu_torch.ops import _build
from nr3d_lib_tpu_torch.ops import permuto_cell as tcell
from nr3d_lib_tpu_torch.ops import permuto_cell4 as t4

torch.set_num_threads(1)

METAS = {"yaml4d": (4, [4.0, 11.0, 32.0, 90.0], 4096),
         "pathd4d": (4, [8.0, 16.0, 32.0, 64.0, 128.0], 4096),
         "small3d": (3, [2.0, 8.0, 24.0], 64)}
KINDS = {"yaml4d": {"dense", "hash"}, "pathd4d": {"hash"},
         "small3d": {"dense", "hash"}}
CASES = [(4, "yaml4d"), (4, "small3d"), (2, "pathd4d"), (2, "small3d")]
N = 1500

# F → the JAX entry points and the port's: (meta, encode, nablas) and
# (meta, encode, frozen-x encode, encode vjp, nablas, nablas vjp)
JAX_OPS = {2: (jcell.make_permuto_cell_meta, jcell.permuto_cell_encode,
               jcell.permuto_cell_nablas),
           4: (j4.make_permuto_cell4_meta, j4.permuto_cell4_encode,
               j4.permuto_cell4_nablas)}
PORT_OPS = {2: (tcell.make_permuto_cell_meta, tcell.permuto_cell_encode,
                tcell.permuto_cell_encode_frozen_x,
                tcell.permuto_cell_encode_bwd_xla, tcell.permuto_cell_nablas,
                tcell.permuto_cell_nablas_bwd_xla),
            4: (t4.make_permuto_cell4_meta, t4.permuto_cell4_encode,
                t4.permuto_cell4_encode_frozen_x,
                t4.permuto_cell4_encode_bwd_xla, t4.permuto_cell4_nablas,
                t4.permuto_cell4_nablas_bwd_xla)}


def _make_case(n_feat: int, name: str):
    d, res, rows = METAS[name]
    jm = JAX_OPS[n_feat][0](d, res, rows)
    tm = PORT_OPS[n_feat][0](d, res, rows)
    rng = np.random.default_rng(len(res))
    x = rng.uniform(0.0, 1.0, (N, d)).astype(np.float32)
    x[:100] = np.round(x[:100] * 8.0) / 8.0              # lattice grid points
    x[100:120] = 0.5
    x[120:200] = x[120:200, :1]                          # equal coordinates
    x[200], x[201] = 0.0, 1.0
    table = rng.uniform(-0.1, 0.1, (jm.total_rows, 64 * n_feat)
                        ).astype(np.float32)
    g = rng.standard_normal((N, n_feat * jm.n_levels)).astype(np.float32)
    return n_feat, jm, tm, x, table, g


@pytest.fixture(scope="module", params=CASES,
                ids=[f"F{f}-{m}" for f, m in CASES])
def case(request):
    """(F, JAX meta, port meta, x, table, g) of each layout and meta."""
    return _make_case(*request.param)


@pytest.fixture(scope="module", params=["small3d", "yaml4d"])
def case4(request):
    """The F=4 cases, without F."""
    return _make_case(4, request.param)[1:]


def _close(got, want, rel: float = 1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, (err, scale)


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ---------------------------------------------------------------- geometry
def test_meta_matches_jax(case, request):
    _, jm, tm, *_ = case
    assert (tm.n_dims, tm.n_levels, tm.total_rows, tm.cells_per_row,
            tm.n_slots) == (jm.n_dims, jm.n_levels, jm.total_rows,
                            jm.cells_per_row, jm.n_slots)
    for a, b in zip(jm.levels, tm.levels):
        assert (a.scale, a.n_rows, a.row_offset, a.box_lo, a.box_dims,
                a.kind) == (b.scale, b.n_rows, b.row_offset, b.box_lo,
                            b.box_dims, b.kind)
    name = request.node.callspec.params["case"][1]
    assert {lv.kind for lv in tm.levels} == KINDS[name]


def test_yaml_meta_sizes():
    """The dynamic NeuS's table: level 0 dense over an (8,8,8,7) box in
    1792 rows, three hashed levels of 4096 rows each."""
    m = t4.make_permuto_cell4_meta(4, [4.0, 11.0, 32.0, 90.0], 4096)
    assert m.levels[0].box_dims == (8, 8, 8, 7) and m.levels[0].n_rows == 1792
    assert [lv.n_rows for lv in m.levels[1:]] == [4096] * 3
    assert m.total_rows == 14080 and m.cells_per_row == 2


def test_hyperplane_scales_match_jax():
    for d in (2, 3, 4, 5):
        x = jnp.ones((1, d), jnp.float32)
        inv_std = (d + 1) * float(np.sqrt(2.0 / 3.0))   # weakly typed
        want = jnp.asarray([1.0 / np.sqrt((i + 1) * (i + 2))
                            for i in range(d)], x.dtype) * inv_std
        np.testing.assert_array_equal(tcell.hyperplane_scales(d),
                                      np.asarray(want))


def test_simplex_parts_match_jax(case):
    _, jm, tm, x, *_ = case
    d = jm.n_dims
    for lv in jm.levels:
        xs = x * np.asarray(lv.scale, np.float32)
        r0, rk, ba = jperm._simplex_parts(jnp.asarray(xs), d)
        t0, tk, tb = tcell._simplex_parts(_t(xs), d)
        np.testing.assert_array_equal(t0.numpy(), np.asarray(r0))
        np.testing.assert_array_equal(tk.numpy(), np.asarray(rk))
        np.testing.assert_allclose(tb.numpy(), np.asarray(ba), rtol=0,
                                   atol=1e-6)
        # every rank row is a permutation of 0..d
        assert (np.sort(tk.numpy(), -1) == np.arange(d + 1)).all()


def test_rows_and_lanes_match_jax(case):
    _, jm, tm, x, *_ = case
    d = jm.n_dims
    for lj, lt in zip(jm.levels, tm.levels):
        rj, lanej, bj, _ = jcell._level_rows_lanes_bary(jnp.asarray(x), lj,
                                                        jm)
        rt, lanet, bt, _ = tcell._level_rows_lanes_bary(_t(x), lt, tm)
        np.testing.assert_array_equal(rt.numpy(), np.asarray(rj))
        np.testing.assert_array_equal(lanet.numpy(),
                                      np.asarray(lanej)[:, :d + 1])
        assert rt.min() >= lt.row_offset and \
            rt.max() < lt.row_offset + lt.n_rows


def test_hash_multiply_is_uint32():
    rng = np.random.default_rng(3)
    a = rng.integers(-2 ** 31, 2 ** 31, 4096).astype(np.int32)
    for p in (1, 2654435761, 805459861, 3674653429):
        want = (a.astype(np.uint32) * np.uint32(p)).astype(np.int64)
        got = tcell._mul_u32(_t(a.astype(np.int64)) & 0xFFFFFFFF, p)
        np.testing.assert_array_equal(got.numpy(), want)


# ----------------------------------------------------------- the encode
def test_encode_matches_jax(case):
    f, jm, tm, x, table, _ = case
    yj = JAX_OPS[f][1](jnp.asarray(x), jnp.asarray(table), jm)
    yt = PORT_OPS[f][1](_t(x), _t(table), tm)
    assert yt.shape == (N, f * tm.n_levels)
    _close(yt.numpy(), yj)


def test_encode_grads_match_jax(case):
    """dL/dx and dL/dtable of the encode against jax.vjp of the JAX entry
    point, and the frozen-x entry point's dL/dtable."""
    f, jm, tm, x, table, g = case
    _, _, frozen, bwd, _, _ = PORT_OPS[f]
    _, vjp = jax.vjp(lambda a, b: JAX_OPS[f][1](a, b, jm),
                     jnp.asarray(x), jnp.asarray(table))
    dxj, dtj = vjp(jnp.asarray(g))
    dxt, dtt = bwd(_t(x), _t(table), _t(g), tm)
    _close(dxt.numpy(), dxj)
    _close(dtt.numpy(), dtj)
    xt = _t(x).requires_grad_(True)
    tt = _t(table).requires_grad_(True)
    frozen(xt, tt, tm).backward(_t(g))
    assert xt.grad is None
    _close(tt.grad.numpy(), dtj)


def test_nablas_match_jax(case):
    f, jm, tm, x, table, g = case
    nj = JAX_OPS[f][2](jnp.asarray(g), jnp.asarray(x), jnp.asarray(table),
                       jm)
    nt = PORT_OPS[f][4](_t(g), _t(x), _t(table), tm)
    _close(nt.numpy(), nj)
    # the nablas are the encode's dL/dx
    dx, _ = PORT_OPS[f][3](_t(x), _t(table), _t(g), tm)
    _close(nt.numpy(), dx.numpy())


def test_nablas_second_order_matches_jax(case):
    """The nablas' vjp (g_up, x, table) against jax.vjp of the JAX
    nablas (its custom vjp is the XLA double backward); dL/dx is zero:
    the weights are affine in x inside a simplex."""
    f, jm, tm, x, table, g = case
    gg = np.random.default_rng(7).standard_normal(
        (N, jm.n_dims)).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b, c: JAX_OPS[f][2](a, b, c, jm),
                     jnp.asarray(g), jnp.asarray(x), jnp.asarray(table))
    dgj, dxj, dtj = vjp(jnp.asarray(gg))
    dgt, dxt, dtt = PORT_OPS[f][5](_t(g), _t(x), _t(table), _t(gg), tm)
    _close(dgt.numpy(), dgj)
    _close(dtt.numpy(), dtj)
    assert not np.abs(np.asarray(dxj)).any() and not dxt.abs().any()
    # the same through the public entry point's autograd
    ga, ta = _t(g).requires_grad_(True), _t(table).requires_grad_(True)
    torch.sum(PORT_OPS[f][4](ga, _t(x), ta, tm) * _t(gg)).backward()
    _close(ga.grad.numpy(), dgj)
    _close(ta.grad.numpy(), dtj)


def test_table_values_are_bf16(case4):
    """The packed path's semantics: a table that bf16 represents exactly
    encodes as its own quantization."""
    jm, tm, x, table, _ = case4
    q = torch.from_numpy(table).to(torch.bfloat16).to(torch.float32)
    yq = t4.permuto_cell4_encode(_t(x), q, tm)
    y = t4.permuto_cell4_encode(_t(x), _t(table), tm)
    np.testing.assert_array_equal(y.numpy(), yq.numpy())


# ------------------------------------------------------- routes and meta
def test_cpu_route_launches_nothing(case):
    f, jm, tm, x, table, g = case
    before = dict(_build.LAUNCHES)
    xt, tt = _t(x).requires_grad_(True), _t(table).requires_grad_(True)
    y = PORT_OPS[f][1](xt, tt, tm)
    nab = PORT_OPS[f][4](_t(g), xt, tt, tm)
    (y.sum() + nab.sum()).backward()
    assert dict(_build.LAUNCHES) == before


def test_c_meta_mirrors_the_meta(case):
    _, _, tm, *_ = case
    m = t4.c_meta(tm)
    d = tm.n_dims
    assert (m.n_dims, m.n_levels, m.cells_per_row) == \
        (d, tm.n_levels, tm.cells_per_row)
    np.testing.assert_array_equal(np.asarray(m.sf[:d], np.float32),
                                  tcell.hyperplane_scales(d))
    for i, lv in enumerate(tm.levels):
        assert (m.lv[i].n_rows, m.lv[i].row_offset, m.lv[i].is_dense) == \
            (lv.n_rows, lv.row_offset, int(lv.kind == "dense"))
        assert list(m.lv[i].scale[:d]) == list(lv.scale)
        if lv.kind == "dense":
            assert tuple(m.lv[i].box_lo[:d]) == lv.box_lo
            assert tuple(m.lv[i].box_dims[:d]) == lv.box_dims


def test_c_meta_refuses_what_the_kernels_cannot_take():
    with pytest.raises(ValueError, match="at most 16 levels"):
        t4.c_meta(t4.make_permuto_cell4_meta(3, [2.0] * 17, 64))
    with pytest.raises(ValueError, match=r"n_dims must be in \[2, 5\]"):
        t4.make_permuto_cell4_meta(6, [2.0], 64)


def test_unsupported_device_raises():
    meta = t4.make_permuto_cell4_meta(3, [2.0], 64)
    x = torch.zeros(4, 3, device="meta")
    for f in (2, 4):
        _, enc, _, _, nab, _ = PORT_OPS[f]
        table = torch.zeros(meta.total_rows, 64 * f, device="meta")
        with pytest.raises(ValueError, match="unsupported device"):
            enc(x, table, meta)
        with pytest.raises(ValueError, match="unsupported device"):
            nab(torch.zeros(4, f, device="meta"), x, table, meta)


@pytest.mark.parametrize("n_feat", [2, 4], ids=["F2", "F4"])
def test_kernel_argument_checks(n_feat):
    """What the kernels cannot take raises before a launch: the checks
    run on any device."""
    meta = tcell.make_permuto_cell_meta(3, [2.0, 8.0], 64)
    x = torch.zeros(4, 3)
    table = torch.zeros(meta.total_rows, 64 * n_feat)
    g_up = torch.zeros(4, n_feat * meta.n_levels)
    tcell.check_cuda_args(x, table, meta, n_feat, "ok", g_up)
    for args, match in (
            ((torch.zeros(4, 4), table), "x must be"),
            ((x.double(), table), "x must be"),
            ((x, torch.zeros(meta.total_rows, 64 * (6 - n_feat))),
             "table must be"),
            ((x, table, torch.zeros(4, 3)), "g_up must be")):
        with pytest.raises(ValueError, match=match):
            tcell.check_cuda_args(args[0], args[1], meta, n_feat, "bad",
                                  *args[2:])


def test_path_d_and_field_meta_sizes():
    """The F=2 metas the card runs: the dynamic NeuS field's default 4D
    lattice (five hashed levels of 4096 rows, 2 cells per row, 10
    features) and the 3D bench lattice (a dense (21, 21, 18) box in 1985
    rows, seven hashed levels, 4 cells per row, 16 features)."""
    m = tcell.make_permuto_cell_meta(4, [8.0, 16.0, 32.0, 64.0, 128.0], 4096)
    assert [lv.kind for lv in m.levels] == ["hash"] * 5
    assert (m.total_rows, m.cells_per_row, m.out_features) == (20480, 2, 10)
    m = tcell.make_permuto_cell_meta(
        3, [16.0 * 2 ** (0.5 * i) for i in range(8)], 4096)
    assert m.levels[0].box_dims == (21, 21, 18) and \
        m.levels[0].n_rows == 1985
    assert [lv.n_rows for lv in m.levels[1:]] == [4096] * 7
    assert (m.total_rows, m.cells_per_row, m.out_features) == (30657, 4, 16)


def test_library_name_hashes_shared_headers(tmp_path, monkeypatch):
    """Both cell permuto sources include `csrc/permuto_simplex.cuh`: an
    edited header must name a new library, so a stale build is never
    loaded."""
    for f in ("permuto_cell.cu", "permuto_cell4.cu", "permuto_simplex.cuh"):
        (tmp_path / f).write_bytes((_build.CSRC_DIR / f).read_bytes())
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    before = {n: _build._lib_path(n) for n in ("permuto_cell",
                                               "permuto_cell4")}
    header = tmp_path / "permuto_simplex.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: _build._lib_path(n) for n in before}
    assert all(after[n] != before[n] for n in before)
    assert '#include "permuto_simplex.cuh"' in \
        (tmp_path / "permuto_cell.cu").read_text()
