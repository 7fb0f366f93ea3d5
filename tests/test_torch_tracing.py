"""The port's span recorder (`nr3d_lib_tpu_torch.profile`): the spans and
counters the training step, the ray query and the renderer record, and
the ring that keeps them.

On the CPU, at a small size (64 rays, an F=4 NeuS and an F=4 NeRF of
width 16, a 16³ grid, 12² frames): the span tree, names and unit ids of
a `Trainer.step` (with and without the occupancy update) and of a
`NeuralRenderer.render`; every child within its parent; the ring keeping
its last `RING_SPANS` spans; `syncs` one a `to_numpy`; a compacting
query's `slots` the rows of its final field pass as the benchmark's
wrapper counts them (rays × budget) and `kept` its `n_compact`; the
record-function range emitted inside a torch.profiler session and never
outside one.

Marked `gpu` (skipped without a card; run there without the suite's
conftest: `python -m pytest tests/test_torch_tracing.py -m gpu
--noconftest`), at the benchmark cells' configurations: a sleep kernel's
device interval lies inside its span within 50 µs on torch.profiler's
clock; and the `syncs` of a training step (a plain one and one with the
occupancy update) and of a frame equal the synchronising operations that
torch's sync debug mode reports there.
"""

import json
import sys
import threading
import warnings
from pathlib import Path

import pytest
import torch

from nr3d_lib_tpu_torch import profile as PR
from nr3d_lib_tpu_torch.models.model_base import LoTDNeRFModel, LoTDNeuSModel

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
ACCEL = {"resolution": 16, "max_steps_per_ray": 32, "step_size": 2.0 / 32,
         "update_every": 2}
ENC = {"lotd_cfg": {"lod_res": [16, 64], "lod_n_feats": 4,
                    "lod_types": ["Dense", "Hash"], "hashmap_size": 2 ** 16},
       "backend": "brick", "hashmap_rows": 64}
NEUS = dict(field_cfg={"surface_cfg": {"encoding_cfg": ENC,
                                       "decoder_cfg": {"D": 1, "W": 16}},
                       "radiance_cfg": {"D": 2, "W": 16}},
            accel_cfg=ACCEL,
            ray_query_cfg={"query_mode":
                           "march_occ_multi_upsample_compressed",
                           "march_budget_factor": 0.5, "n_importance": 8})
NERF = dict(field_cfg={"encoding_cfg": ENC,
                       "density_decoder_cfg": {"D": 1, "W": 16},
                       "radiance_cfg": {"D": 2, "W": 16}},
            accel_cfg=ACCEL,
            ray_query_cfg={"query_mode": "march_occ_compressed"})
# the compressed NeuS query's spans under `query`, with their depths: the
# march with its budget, the slab's SDF pass, three upsample rounds (each
# with its new samples' SDF pass), the early-stop SDF pass, the
# compaction, the final pass and the composite
QUERY = [(0, "query"), (1, "query.march"), (1, "query.field")] + \
    [(1, "query.upsample"), (2, "query.field")] * 3 + \
    [(1, "query.field"), (1, "query.compact"), (1, "query.field"),
     (1, "query.composite")]


def _sample(n: int, gen: torch.Generator) -> dict:
    """n rays from a sphere of radius 2 towards the centre, and colours."""
    dev = gen.device
    o = torch.randn((n, 3), generator=gen, device=dev)
    o = o / torch.linalg.norm(o, dim=-1, keepdim=True) * 2.0
    d = torch.rand((n, 3), generator=gen, device=dev) * 0.5 - 0.25 - o
    return {"o": o, "d": d / torch.linalg.norm(d, dim=-1, keepdim=True),
            "rgb": torch.rand((n, 3), generator=gen, device=dev)}


def _loss(model, batch, gen):
    rendered, vb = model.ray_query(model.ray_test(batch["o"], batch["d"]),
                                   generator=gen)
    rgb_l = torch.mean((rendered["rgb_volume"] - batch["rgb"]) ** 2)
    eik = torch.mean((torch.linalg.norm(vb["nablas_packed"], dim=-1)
                      - 1.0) ** 2)
    return rgb_l + 0.03 * eik, rgb_l


def _trainer(model_kw: dict, dev, rays: int = 64):
    from examples_torch.common import Trainer

    model = LoTDNeuSModel(**model_kw, device=dev)
    model.populate()
    return Trainer(model, _loss, _sample, lr=3e-3, rays=rays, clip=5.0)


def _unit(root: str, unit: int):
    """The last closed span `root` of this unit and every span under it,
    in the order they opened, each with its depth below the root."""
    spans = PR.spans()
    top = [s for s in spans if s.name == root and s.unit == unit][-1]
    out = []
    for s in spans:
        depth, up = 0, s
        while up is not None and up is not top:
            up, depth = up.parent, depth + 1
        if up is top:
            out.append((depth, s))
    return [(d, s) for d, s in sorted(out, key=lambda x: (x[1].t0, x[0]))]


def _check_nesting(tree):
    for _, s in tree:
        assert s.t0 <= s.t1
        if s.parent is not None and s.parent.t1:
            assert s.parent.t0 <= s.t0 and s.t1 <= s.parent.t1, s.name


# --------------------------------------------------------------- the CPU
def test_training_step_span_tree():
    tr = _trainer(NEUS, "cpu")
    assert tr.lifecycle_every == 2
    for it in range(2):
        tr.step(it)
    for it, update in ((0, True), (1, False)):
        tree = _unit("step", it)
        names = [(d, s.name) for d, s in tree]
        life = [(1, "step.lifecycle"), (2, "occ.update")] if update else []
        assert names == [(0, "step")] + life + [
            (1, "step.sample"), (1, "step.forward")] + \
            [(2 + d, n) for d, n in QUERY] + [
            (1, "step.backward"), (1, "step.clip"), (1, "step.optimizer")]
        assert {s.unit for _, s in tree} == {it}
        _check_nesting(tree)
        # the plain step's one wait: the composite's cumprod backward
        assert {s.name: s.syncs for _, s in tree if s.syncs} == \
            ({"occ.update": 2} if update else {}) | {"step.backward": 1}


def test_render_span_tree_and_syncs():
    from nr3d_lib_tpu_torch.gui import NeuralRenderer

    model = LoTDNeRFModel(**NERF, device="cpu")
    model.populate()
    r = NeuralRenderer(model, (12, 12), ray_chunk=100)
    c2w = torch.eye(4)
    c2w[:3, 3] = torch.tensor([0.0, 0.0, -2.5])
    frames = r.frames
    for _ in range(2):
        images = r.render(c2w)
    assert r.frames == frames + 2
    tree = _unit("frame", frames + 1)
    q = [(2, "query"), (3, "query.march"), (3, "query.field"),
         (3, "query.compact"), (3, "query.field"), (3, "query.composite")]
    chunk = [(1, "frame.chunk")] + q + [(1, "frame.to_host")]
    assert [(d, s.name) for d, s in tree] == \
        [(0, "frame"), (1, "frame.rays")] + chunk * 2 + \
        [(1, "frame.assemble")]
    assert {s.unit for _, s in tree} == {frames + 1}
    _check_nesting(tree)
    # a host pose's copy, and one wait an output of each chunk
    waits = [(s.name, s.syncs) for _, s in tree if s.syncs]
    assert waits == [("frame.rays", 1)] + \
        [("frame.to_host", len(images))] * 2


def test_ring_keeps_its_last_spans(monkeypatch):
    assert PR._thread().ring.maxlen == PR.RING_SPANS >= 65_536
    monkeypatch.setattr(PR, "RING_SPANS", 8)
    got = []

    def body():                      # a new thread: a new ring of 8
        for i in range(20):
            with PR.profile(f"s{i}", unit=i):
                pass
        got.extend(PR.spans())
        got.extend(PR.spans())       # reading does not clear it

    t = threading.Thread(target=body)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive()
    assert [s.name for s in got] == [f"s{i}" for i in range(12, 20)] * 2
    assert [s.unit for s in got[:8]] == list(range(12, 20))


def test_syncs_count_one_a_to_numpy():
    from nr3d_lib_tpu_torch.utils import to_numpy

    with PR.profile("outer"):
        to_numpy(torch.ones(3))
        with PR.profile("inner"):
            to_numpy(torch.ones(2))
            to_numpy(torch.ones(2))
        to_numpy([1.0, 2.0])         # not a tensor: nothing read
    inner, outer = PR.spans()[-2:]
    assert (inner.name, inner.syncs) == ("inner", 2)
    assert (outer.name, outer.syncs) == ("outer", 1)
    PR.count_sync()                  # no span open: charged to none


@pytest.mark.parametrize("kind", ["neus", "nerf"])
def test_query_slots_and_kept(kind):
    sys.path.insert(0, str(ROOT / "benchmark"))
    try:
        from harness.counters import Counters
    finally:
        sys.path.remove(str(ROOT / "benchmark"))
    if kind == "neus":
        model = LoTDNeuSModel(**NEUS, device="cpu")
        last = "field.implicit_surface.encoding"
        counted = {"encodings": [last], "mlps": []}
    else:
        model = LoTDNeRFModel(**NERF, device="cpu")
        last = "field.radiance.mlp"
        counted = {"encodings": [], "mlps": [last]}
    model.populate()
    wrapper = Counters(model, counted, training=False)
    wrapper.active = True
    batch = _sample(64, torch.Generator().manual_seed(3))
    with torch.no_grad():
        _, vb = model.ray_query(model.ray_test(batch["o"], batch["d"]))
    q = PR.spans()[-1]
    r, b = vb["valid"].shape
    assert q.name == "query" and q.slots == r * b
    assert [c.rows for c in wrapper.take() if c.module == last][-1] == \
        q.slots
    assert q.kept is vb["n_compact"]
    assert int(q.kept) == int(vb["valid"].sum()) > 0


def test_record_function_only_inside_a_session(monkeypatch):
    from torch.profiler import ProfilerActivity, profile

    def refuse(name):
        raise AssertionError(f"record function {name} outside a session")

    monkeypatch.setattr(PR, "_RecordFunctionFast", refuse)
    with PR.profile("tracing.outside"):
        torch.ones(4).sum()
    with pytest.raises(AssertionError):
        with profile(activities=[ProfilerActivity.CPU]):
            with PR.profile("tracing.refused"):
                pass
    monkeypatch.undo()
    with profile(activities=[ProfilerActivity.CPU]) as session:
        with PR.profile("tracing.inside", unit=7):
            with PR.profile("tracing.child"):
                torch.ones(4).sum()
    keys = {e.key for e in session.key_averages()}
    assert {"tracing.inside", "tracing.child"} <= keys
    assert "tracing.outside" not in keys
    child, top = PR.spans()[-2:]
    assert (top.name, child.name, child.unit) == \
        ("tracing.inside", "tracing.child", 7)


# --------------------------------------------------------------- the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_span_clock_is_the_device_traces(cuda):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for acts in ([ProfilerActivity.CUDA],
                 [ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        with profile(activities=acts) as session:
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            with PR.profile("tracing.sleep"):
                torch.cuda._sleep(2_000_000)
                torch.cuda.synchronize()
        span = PR.spans()[-1]
        kernels = [e for e in session.profiler.kineto_results.events()
                   if e.device_type() == DeviceType.CUDA and
                   "spin_kernel" in e.name()]
        k = max(kernels, key=lambda e: e.duration_ns())
        assert k.duration_ns() > 500_000
        assert span.t0 - 50_000 <= k.start_ns()
        assert k.end_ns() <= span.t1 + 50_000


def _cell_kwargs(config: str) -> dict:
    cfg = json.loads((ROOT / "benchmark" / "configs" / f"{config}.json")
                     .read_text())
    return cfg["program"]["kwargs"]


def _waits(fn) -> int:
    """fn() under torch's sync debug mode → the synchronising operations
    it reported."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sum("called a synchronizing CUDA operation" in str(w.message)
               for w in caught)


@pytest.mark.gpu
def test_syncs_are_the_sync_debug_modes(cuda):
    from nr3d_lib_tpu_torch.gui import NeuralRenderer

    tr = _trainer(_cell_kwargs("neus_w4"), cuda, rays=4096)
    every = tr.model.accel.update_every
    for it in range(every + 1):             # every shape, set-up's update
        tr.step(it)
    for it in (every + 1, 2 * every):       # a plain step, an update
        torch.cuda.synchronize()
        waits = _waits(lambda: tr.step(it))
        torch.cuda.synchronize()
        assert sum(s.syncs for _, s in _unit("step", it)) == waits >= 1
    model = LoTDNeRFModel(**_cell_kwargs("nerf_w4"), device=cuda)
    model.populate()
    r = NeuralRenderer(model, (200, 200), ray_chunk=40_000)
    c2w = torch.eye(4, device=cuda)
    c2w[:3, 3] = torch.tensor([0.0, 0.0, -2.5], device=cuda)
    r.render(c2w)
    torch.cuda.synchronize()
    waits = _waits(lambda: r.render(c2w))
    assert sum(s.syncs for _, s in _unit("frame", r.frames - 1)) == \
        waits == 3
