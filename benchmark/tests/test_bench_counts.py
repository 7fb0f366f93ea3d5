"""The yardstick's counts on small known shapes, the trace arithmetic, the
readers, and the counters' rows."""

import pytest
import torch

from harness import readers, yardstick as Y
from harness.counters import Call, Counters
from harness.trace import Stretch, Trace, _union_and_gaps


def test_bound_is_the_longer_of_bytes_and_operations():
    assert Y.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert Y.bound_s(0, 67e12) == pytest.approx(1.0)
    assert Y.bound_s(3.35e12, 2 * 67e12) == pytest.approx(2.0)


@pytest.mark.parametrize("kind,need_dx,want", [
    ("fwd", False, (10 * (12 + 32) + 3 * 512, 10 * 2 * 92)),
    ("bwd", False, (10 * (12 + 32) + 3 * 1024, 10 * 2 * 92)),
    ("bwd", True, (10 * (12 + 32 + 128 + 12) + 3 * 1024, 10 * 2 * 220)),
    ("dydx", False, (10 * (12 + 32 + 12) + 3 * 512, 10 * 2 * 146)),
    ("bwd2", False, (10 * (32 + 24 + 32) + 3 * 512 + 3 * 1024,
                     10 * 2 * 234)),
    ("bwd2", True, (10 * (32 + 24 + 32 + 12) + 3 * 512 + 3 * 1024,
                    10 * 2 * 434)),
])
def test_brick4_work(kind, need_dx, want):
    assert Y.brick4_work(kind, 10, 2, 3, need_dx) == want


def test_mlp_flops():
    assert Y.mlp_flops_per_row([(11, 64), (64, 16)]) == 2 * (704 + 1024)


def test_union_and_gaps():
    busy, gaps = _union_and_gaps([(0, 2, "a"), (1, 3, "b"), (5, 6, "c"),
                                  (5.5, 9, "d")])
    assert busy == 7
    assert gaps == [(3, 5, "c")]


class _Model(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.dec = torch.nn.Module()
        self.dec.ws = torch.nn.ParameterList(
            [torch.nn.Parameter(torch.zeros(11, 64)),
             torch.nn.Parameter(torch.zeros(64, 16))])


class _Cell:
    config = {"counted": {"mlps": ["dec"], "nablas_mlp": "dec",
                          "encoding_table": {"levels": 2, "rows": 3}}}
    traffic = {"kind": "train", "rays_per_step": 4}


class _Run:
    model = _Model()


def _ctx():
    calls = [Call("enc", "fwd", 100, False, False),
             Call("enc", "fwd", 10, True, False),
             Call("enc", "nablas", 10, True, False),
             Call("dec", "mlp", 110, False, False)]
    s = Stretch(window_s=2.0, busy_s=1.5, n_device_events=30,
                device_s={"void brick4_fwd_kernel<2>": 1e-3,
                          "gemm": 0.5}, units=3, gaps=[], calls=calls)
    return readers.Context(_Cell(), Trace([s], 2.0 / 3), _Run())


def test_readers_on_a_known_stretch():
    ctx = _ctx()
    assert readers.device_idle(ctx) == pytest.approx(25.0)
    assert readers.events_per_unit(ctx) == pytest.approx(10.0)
    assert readers.samples_per_ray(ctx) == pytest.approx(110 / 12)
    bound = sum(Y.bound_s(*Y.brick4_work(k, n, 2, 3)) for k, n in
                [("fwd", 100), ("fwd", 10), ("bwd", 10), ("dydx", 10),
                 ("bwd2", 10)])
    assert readers.encode_roofline(ctx, r"^(void )?brick4_") == \
        pytest.approx(100 * bound / 1e-3)
    assert readers.encode_roofline(ctx, r"^nothing") is None
    enc_ops = sum(Y.brick4_work(k, n, 2, 3)[1] for k, n in
                  [("fwd", 100), ("fwd", 10), ("bwd", 10), ("dydx", 10),
                   ("bwd2", 10)])
    flops = 110 * 3456 + 10 * 3456 * 3 + enc_ops
    assert readers.mfu(ctx) == pytest.approx(100 * flops / (2.0 * 67e12))


def test_counters_take_rows_from_the_shapes():
    from nr3d_lib_tpu_torch.models.model_base import LoTDNeuSModel

    from harness import spec

    cfg = spec.find_cell("neus_w4_train_16k", spec.load_benchmark()).config
    model = LoTDNeuSModel(**cfg["program"]["kwargs"], device="cpu")
    c = Counters(model, cfg["counted"], training=True)
    x = torch.rand(7, 3) * 2 - 1
    model.forward_sdf(x)
    assert c.take() == []                      # inactive: nothing counted
    c.active = True
    with torch.no_grad():
        model.forward_sdf(x)
    model(x, torch.nn.functional.normalize(x, dim=-1))
    kinds = [(k.module.split(".")[-1], k.kind, k.rows, k.grad)
             for k in c.take()]
    assert kinds == [("encoding", "fwd", 7, False),
                     ("decoder", "mlp", 7, False),
                     ("encoding", "fwd", 7, True),
                     ("decoder", "mlp", 7, True),
                     ("encoding", "nablas", 7, True),
                     ("mlp", "mlp", 7, True)]


def test_reference_encoding_is_the_ports_plain_one():
    from nr3d_lib_tpu_torch.ops import lotd_brick4 as B4

    from reference import brick

    levels = brick.make_levels([16, 64], ["Dense", "Hash"], 64)
    meta = B4.make_brick4_meta([16, 64], ["Dense", "Hash"], 64)
    gen = torch.Generator().manual_seed(0)
    flat = torch.rand(sum(brick.level_param_sizes(levels)),
                      generator=gen) * 0.2 - 0.1
    table = brick.build_table(flat, levels)
    x = torch.rand(257, 3, generator=gen) * 2 - 1
    ours = brick.encode(x, table, levels)
    # the port's table from the same flat vector (its dense gather)
    dense = torch.as_tensor(B4.dense_brick4_index(meta.levels[0]))
    rows = [flat[:16384][dense], flat[16384:].reshape(-1, 256)]
    port = B4.brick4_encode_xla(x * 0.5 + 0.5, torch.cat(rows), meta)
    assert torch.equal(ours, port)
