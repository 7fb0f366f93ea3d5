"""The time-conditioned F=4 permutohedral NeuS (`DynamicPermutoNeuSModel`
at `examples/configs/dynamic_permuto_w4.yaml`'s widths) against the
benchmark's plain reference (`benchmark/reference/dyn_permuto.py`), and
the entry points, spans and counters that the benchmark reads of it.

On the CPU, at a small size (the configuration's widths with a smaller
hashed table, a few dozen rays, seeded random weights handed to both
sides): the 4D lattice's encode bitwise and its nablas; the dense
query's samples, sdf, nablas and rgb at the final slots and the rendered
colour; three training steps (loss, the first gradient as Adam took it,
the parameters' change) through the benchmark's training driver, its
recipe and `Trainer.step`; the reference with bfloat16 products failing
a tolerance; the benchmark's `Counters` counting the bank's encode and
nablas calls with their rows; the spans `query` (with `samples`),
`query.field`, `query.composite`, `occ.update` (with `keys` and
`cells`) and `enc.nablas_bwd` (charged to the forward's thread); the
lattice's work counts and the readers over a known stretch.

Marked `gpu` (skipped without a card; run there with `python -m pytest
tests/test_torch_dyn_permuto_bench.py -m gpu --noconftest`): the same
field comparison through B14, B15 and B16, the nablas' backward inside
its span.
"""

import contextlib
import copy
import json
import sys
from pathlib import Path

import pytest
import torch

from nr3d_lib_tpu_torch import profile as PR
from nr3d_lib_tpu_torch.models.model_families import DynamicPermutoNeuSModel

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


@contextlib.contextmanager
def _benchmark_on_path():
    """The benchmark's packages (`harness`, `reference`, `recipes`)
    importable by name, as `benchmark/run.py` has them."""
    sys.path.insert(0, str(ROOT / "benchmark"))
    try:
        yield
    finally:
        sys.path.remove(str(ROOT / "benchmark"))


with _benchmark_on_path():
    from harness import permuto_work as PW
    from harness import readers, spec
    from harness.counters import Call, Counters
    from harness.trace import Stretch, Trace
    from reference import dyn_permuto as R
    from reference.common import generator, uniform_draw

CFG = json.loads((ROOT / "benchmark" / "configs" / "dyn_permuto_w4.json")
                 .read_text())
ROWS = 2048           # rows a hashed level: the first level stays dense
N_RAYS = 24


def _cfg(rows: int = ROWS) -> dict:
    cfg = copy.deepcopy(CFG)
    cfg["program"]["kwargs"]["field_cfg"]["surface_cfg"]["permuto_cfg"][
        "hashmap_rows"] = rows
    return cfg


def _pair(device="cpu", seed=7):
    """The port's model and the reference's weights, the same tensors."""
    cfg = _cfg()
    weights = R.make_weights(cfg, generator(device, seed, "weights"))
    model = DynamicPermutoNeuSModel(**cfg["program"]["kwargs"],
                                    device=device)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(weights[name])
    return cfg, weights, model


def _rays(n=N_RAYS, device="cpu", seed=3):
    g = torch.Generator(device).manual_seed(seed)
    o = torch.nn.functional.normalize(
        torch.randn(n, 3, generator=g, device=device), dim=-1) * 3.0
    target = (torch.rand(n, 3, generator=g, device=device) - 0.5) * 0.6
    d = torch.nn.functional.normalize(target - o, dim=-1)
    ts = torch.rand(n, generator=g, device=device) * 2.0 - 1.0
    return o, d, ts


# ----------------------------------------------------------- the lattice
def test_lattice_layout_and_encode_match_the_port():
    """The reference's levels are the port's meta, and its encode is
    bitwise the port's plain one (both on the CPU: the same simplex, the
    same rows, the same float32 operations), points outside [0, 1]
    included (the rays that miss the box sample there)."""
    _, weights, model = _pair()
    bank = model.field.implicit_surface.bank
    levels = R.make_levels(4, [4.0, 11.0, 32.0, 90.0], ROWS)
    assert [(lv.n_rows, lv.row_offset, lv.box_dims is not None)
            for lv in levels] == \
        [(l.n_rows, l.row_offset, l.box_dims is not None)
         for l in bank.meta.levels] == \
        [(1792, 0, True), (2048, 1792, False), (2048, 3840, False),
         (2048, 5888, False)]
    p = torch.rand(3000, 4, generator=torch.Generator().manual_seed(1))
    p = p * 1.6 - 0.3
    table = weights[R.TABLE]
    assert torch.equal(R.encode(p, table, levels), bank(p))


def test_lattice_nablas_match_the_ports():
    """Autograd of the plain lattice against the bank's nablas (the
    port's written-out J^T g); the same bits up to float32 summation
    order."""
    _, weights, model = _pair()
    bank = model.field.implicit_surface.bank
    levels = R.make_levels(4, [4.0, 11.0, 32.0, 90.0], ROWS)
    g = torch.Generator().manual_seed(2)
    p = torch.rand(2000, 4, generator=g).requires_grad_(True)
    g_up = torch.randn(2000, 16, generator=g)
    y = R.encode(p, weights[R.TABLE], levels)
    (want,) = torch.autograd.grad(y, p, g_up)
    torch.testing.assert_close(bank.nablas_path(p.detach(), g_up), want,
                               rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------- the query
def _port_query(model, o, d, ts, draw_seed=5):
    tested = model.ray_test(o, d)
    tested["ts"] = ts
    gen = torch.Generator().manual_seed(draw_seed)
    rendered, vb = model.ray_query(tested, draw=uniform_draw(gen))
    return rendered, vb


# float32 in a different order of operations (the reference's autograd
# nablas and whole-batch matmuls against the port's split vjp) moves the
# field's outputs by a few ulps; bf16 products move them by ~1e-3
FIELD_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16_control"])
def test_dense_query_matches_the_reference(dtype):
    """The samples (the same draws), and sdf, nablas and rgb at every
    final slot and the rendered colour; the reference with bfloat16
    products (the benchmark's control) fails the field's tolerance."""
    cfg, weights, model = _pair()
    o, d, ts = _rays()
    rendered, vb = _port_query(model, o, d, ts)
    o_n, d_n, t, valid, mask = R.Model(cfg, weights).samples(
        o, d, ts, uniform_draw(torch.Generator().manual_seed(5)))
    assert torch.equal(t, vb["t"]) and bool(valid.all())
    ref = R.Model(cfg, weights, dtype=dtype)
    r, s = t.shape
    assert (r, s) == (N_RAYS, 96)
    x = (o_n[:, None] + d_n[:, None] * t[..., None]).reshape(-1, 3)
    v = d[:, None].expand(r, s, 3).reshape(-1, 3)
    sdf, nab, rgb = ref.field(x, v, ts.repeat_interleave(s))
    out = model(x, v, ts.repeat_interleave(s))
    got = (out["sdf"], out["nablas"], out["rgb"])
    rgb_ref, nab_ref = ref.composite(o_n, d_n, d, ts, t, valid, mask)
    if dtype == torch.float32:
        for a, b in zip(got, (sdf, nab, rgb)):
            torch.testing.assert_close(a.detach(), b.detach(), **FIELD_TOL)
        torch.testing.assert_close(vb["nablas"].reshape(-1, 3).detach(),
                                   nab.detach(), **FIELD_TOL)
        torch.testing.assert_close(rendered["rgb_volume"].detach(),
                                   rgb_ref.detach(), **FIELD_TOL)
    else:
        with pytest.raises(AssertionError):
            for a, b in zip(got, (sdf, nab, rgb)):
                torch.testing.assert_close(a.detach(), b.detach(),
                                           **FIELD_TOL)


# ------------------------------------------------------------ the steps
def _small_cell():
    with _benchmark_on_path():
        cell = spec.find_cell("dyn_permuto_train_16k",
                              spec.load_benchmark())
    tr = cell.traffic
    cam = tr["camera"]
    cam["focal"] = cam["focal"] * 16 / cam["hw"][0]
    cam["hw"] = [16, 16]
    tr.update(rays_per_step=48, n_views=2, replay_updates=1)
    kw = cell.config["program"]["kwargs"]
    kw["accel_cfg"]["update_every"] = 2
    kw["field_cfg"]["surface_cfg"]["permuto_cfg"]["hashmap_rows"] = ROWS
    return cell


STEP_TOL = 1e-5


def test_three_steps_and_a_window_step_match_the_reference():
    """The benchmark's training driver on the CPU: `Trainer.step` with the
    recipe's per-ray timestamps, steps 0-2 and the replayed update step
    4 against the reference, and the control (the reference with
    bfloat16 products) failing. Both sides run the plain lattice here,
    so the gaps are float32 order alone (the reference sums its chunks'
    gradients, the port differentiates through the split nablas): under
    1e-6. STEP_TOL leaves ten times that; the control reads ~1e-3."""
    cell = _small_cell()
    run = cell.driver(cell, 2_900_000_011, torch.device("cpu"))
    run.setup()
    run.free_program()              # steps on to the replayed step
    gaps = run.check()
    assert run.replay_it == 4
    assert set(gaps) == {"loss_gap", "grad_gap", "change_gap",
                         "window_loss_gap", "window_grad_gap",
                         "window_change_gap"}
    assert max(gaps.values()) < STEP_TOL, gaps
    assert max(run.control().values()) > STEP_TOL


def test_recipe_refuses_a_bank_without_entry_points():
    """The cell counts the bank at `forward` and `nablas_path`: a program
    without them fails at set-up in every run, traced or not."""
    cell = _small_cell()
    model = DynamicPermutoNeuSModel(**cell.config["program"]["kwargs"],
                                    device="cpu")
    cell.recipe.measurable(model, cell.config)
    bank = model.field.implicit_surface.bank
    bank.nablas_path = None
    with pytest.raises(TypeError, match="nablas_path"):
        cell.recipe.measurable(model, cell.config)


# ------------------------------------------------ counters and spans
def test_counters_count_the_banks_calls():
    cfg, _, model = _pair()
    c = Counters(model, cfg["counted"], training=True)
    c.active = True
    x = torch.rand(11, 3) * 2 - 1
    ts = torch.rand(11) * 2 - 1
    with torch.no_grad():
        model.implicit_surface.forward_sdf(x, ts)
    model(x, torch.nn.functional.normalize(x, dim=-1), ts)
    kinds = [(k.module.split(".")[-1], k.kind, k.rows, k.grad)
             for k in c.take()]
    assert kinds == [("bank", "fwd", 11, False),
                     ("decoder", "mlp", 11, False),
                     ("bank", "fwd", 11, True),
                     ("decoder", "mlp", 11, True),
                     ("bank", "nablas", 11, True),
                     ("mlp", "mlp", 11, True)]


def test_query_and_update_open_their_spans():
    cfg, _, model = _pair()
    o, d, ts = _rays(8)
    with PR.profile("outer"):
        _port_query(model, o, d, ts)
        with torch.no_grad():
            model.training_before_per_step(0)
            model.training_before_per_step(1)       # off the interval
    spans = PR.spans()
    i = max(k for k, s in enumerate(spans) if s.name == "outer")
    mine = [s for s in spans[:i] if s.t0 >= spans[i].t0]
    names = [s.name for s in mine]
    assert names.count("query") == 1 and names.count("occ.update") == 1
    q = next(s for s in mine if s.name == "query")
    assert q.counts == {"samples": 8 * 96} and q.parent is spans[i]
    under_q = [s.name for s in mine if s.parent is q]
    assert under_q[-2:] == ["query.field", "query.composite"]
    assert under_q.count("query.upsample") == 2
    upd = next(s for s in mine if s.name == "occ.update")
    res = model.accel.occ.resolution
    assert upd.counts == {"keys": 8, "cells": 8 * (res[0] ** 3 // 4)}


def test_nablas_backward_span_goes_to_the_forwards_thread(monkeypatch):
    """`_Permuto4Nablas` (the card's route, its B16 launch stubbed out
    here): its backward opens `enc.nablas_bwd` under the span open in the
    forward's thread, even when another thread runs it, as autograd does
    for a card."""
    import threading

    from nr3d_lib_tpu_torch.ops import permuto_cell4 as PC4

    monkeypatch.setattr(
        PC4, "_dydx_cuda", lambda g, x, packed, meta: torch.zeros_like(x))
    meta = PC4.make_permuto_cell4_meta(4, [4.0, 11.0], 64)
    table = torch.randn(meta.total_rows, 256).requires_grad_(True)
    g_up = torch.randn(5, 8).requires_grad_(True)
    out = PC4._Permuto4Nablas.apply(g_up, torch.rand(5, 4), table, meta)
    with PR.profile("step.backward"):
        worker = threading.Thread(target=lambda: out.sum().backward())
        worker.start()
        worker.join()
    bwd, top = PR.spans()[-2:]
    assert (bwd.name, top.name) == ("enc.nablas_bwd", "step.backward")
    assert bwd.parent is top and top.t0 <= bwd.t0 <= bwd.t1 <= top.t1
    assert table.grad is not None and g_up.grad is not None


# ------------------------------------------------- work and readers
def test_permuto_work_counts():
    s = PW.search_ops(4)
    assert s == 19 + 20 + 5 + 20 + 22 + 10 + 20
    assert PW.permuto4_work("fwd", 10, 4, 2, 3) == \
        (10 * (16 + 32) + 3 * 512, 10 * 2 * (s + 5 * 8))
    assert PW.permuto4_work("bwd", 10, 4, 2, 3) == \
        (10 * (16 + 32) + 3 * 1024, 10 * 2 * (s + 5 * 8))
    assert PW.permuto4_work("dydx", 10, 4, 2, 3) == \
        (10 * (32 + 16 + 16) + 3 * 512, 10 * 2 * (s + 5 * 10 + 24))
    assert PW.permuto4_work("bwd2", 10, 4, 2, 3) == \
        (10 * (32 + 16 + 16 + 32) + 3 * 512 + 3 * 1024,
         10 * 2 * (s + 5 * 18 + 24))


class _Cell:
    config = {"counted": {"mlps": ["dec"], "nablas_mlp": "dec",
                          "encoding_table": {"levels": 2, "rows": 3,
                                             "dims": 4}}}
    traffic = {"kind": "train", "rays_per_step": 4}


class _Run:
    model = torch.nn.Module()
    model.dec = torch.nn.Module()
    model.dec.ws = torch.nn.ParameterList(
        [torch.nn.Parameter(torch.zeros(19, 64)),
         torch.nn.Parameter(torch.zeros(64, 16))])


def test_readers_over_a_known_stretch():
    calls = [Call("bank", "fwd", 100, False, False),
             Call("bank", "fwd", 10, True, False),
             Call("bank", "nablas", 10, True, False),
             Call("dec", "mlp", 110, False, False)]
    st = Stretch(window_s=2.0, busy_s=1.5, n_device_events=30,
                 device_s={"void permuto4_fwd_kernel": 1e-3,
                           "elementwise": 0.5}, units=3, gaps=[],
                 calls=calls)
    ctx = readers.Context(_Cell(), Trace([st], 2.0 / 3), _Run())
    work = [("fwd", 100), ("fwd", 10), ("bwd", 10), ("dydx", 10)]
    bound = sum(PW.Y.bound_s(*PW.permuto4_work(k, n, 4, 2, 3))
                for k, n in work)
    assert PW.kernel_roofline(ctx, r"^(void )?permuto4_",
                              ("fwd", "bwd", "dydx")) == \
        pytest.approx(100 * bound / 1e-3)
    assert PW.kernel_roofline(ctx, r"^nothing", ("fwd",)) is None
    ops = sum(PW.permuto4_work(k, n, 4, 2, 3)[1]
              for k, n in work + [("bwd2", 10)])
    mlp = 2 * (19 * 64 + 64 * 16)
    assert PW.mfu(ctx) == pytest.approx(
        100 * (110 * mlp + 10 * mlp * 3 + ops) / (2.0 * 67e12))
    assert readers.samples_per_ray(ctx) == pytest.approx(110 / 12)


# --------------------------------------------------------------- the card
@pytest.mark.gpu
def test_field_through_the_kernels_matches_the_reference():
    """B14 encode, B16 nablas and the nablas' backward (in its span) with
    B15 under a loss's backward, against the reference on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from nr3d_lib_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cfg, weights, model = _pair(dev)
    o, d, ts = _rays(64, dev)
    ref = R.Model(cfg, weights)
    o_n, d_n, t, _, _ = ref.samples(o, d, ts)
    ref.w[R.TABLE].requires_grad_(True)
    r, s = t.shape
    x = (o_n[:, None] + d_n[:, None] * t[..., None]).reshape(-1, 3)
    v = d[:, None].expand(r, s, 3).reshape(-1, 3)
    tr = ts.repeat_interleave(s)
    sdf, nab, rgb = ref.field(x, v, tr)
    _build.LAUNCHES.clear()
    out = model(x, v, tr)
    for a, b in zip((out["sdf"], out["nablas"], out["rgb"]), (sdf, nab, rgb)):
        torch.testing.assert_close(a.detach(), b.detach(), rtol=1e-4,
                                   atol=1e-4)
    eik = ((torch.linalg.norm(out["nablas"], dim=-1) - 1) ** 2).mean()
    with PR.profile("step.backward"):
        (out["rgb"].mean() + eik).backward()
    torch.cuda.synchronize()
    assert dict(_build.LAUNCHES) == {"permuto4_fwd": 1, "permuto4_dydx": 1,
                                     "permuto4_bwd": 1}
    bwd, top = PR.spans()[-2:]
    assert (bwd.name, top.name) == ("enc.nablas_bwd", "step.backward")
    eik_r = ((torch.linalg.norm(nab, dim=-1) - 1) ** 2).mean()
    (g_ref,) = torch.autograd.grad(rgb.mean() + eik_r, ref.w[R.TABLE])
    g = model.field.implicit_surface.bank.flattened_params.grad
    assert float(torch.linalg.norm(g - g_ref) / torch.linalg.norm(g_ref)) \
        < 1e-3
