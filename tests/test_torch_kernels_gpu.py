"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Marked `gpu`: here (no card) every test skips. On a machine with a card,
whose Python has no JAX, run without the suite's conftest:

    python -m pytest tests/test_torch_kernels_gpu.py -m gpu --noconftest

Whether a card is present is decided inside the `cuda` fixture, never at
import time. Tolerances: B1 sums 8 weighted corners in another order
(1e-5 relative to the output scale); B3 sums over corners, features and
levels and scales by res-2 (1e-4); B5 is a copy (exact).
"""

import numpy as np
import pytest
import torch

from nr3d_lib_tpu_torch.ops import _build
from nr3d_lib_tpu_torch.ops import gather1d as G
from nr3d_lib_tpu_torch.ops import lotd_brick4 as B4

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


def test_cuda_route_refuses_gradients(cuda):
    meta, x, table = _inputs(cuda, 128)
    with pytest.raises(NotImplementedError, match="slice 2"):
        B4.brick4_encode(x, table.requires_grad_(True), meta)
    with pytest.raises(NotImplementedError, match="slice 2"):
        B4.brick4_nablas(torch.zeros(128, 8, device=cuda), x, table, meta)


def test_render_goes_through_the_kernels(cuda):
    from nr3d_lib_tpu_torch.models.model_base import LoTDNeuSModel

    enc = {"lotd_cfg": {"lod_res": [16, 64], "lod_n_feats": 4,
                        "lod_types": ["Dense", "Hash"]}, "backend": "brick"}
    model = LoTDNeuSModel(
        field_cfg={"surface_cfg": {"encoding_cfg": enc,
                                   "decoder_cfg": {"D": 1, "W": 64}},
                   "radiance_cfg": {"D": 2, "W": 64}},
        accel_cfg={"resolution": 32, "max_steps_per_ray": 48,
                   "step_size": 2.0 / 48},
        ray_query_cfg={"query_mode": "march_occ_multi_upsample_compressed",
                       "march_budget_factor": 0.5})
    assert model.device.type == "cuda"
    rng = np.random.default_rng(3)
    o = rng.normal(size=(256, 3))
    o = (o / np.linalg.norm(o, axis=-1, keepdims=True) * 2.0)
    d = -o / np.linalg.norm(o, axis=-1, keepdims=True)
    o, d = (torch.from_numpy(a.astype(np.float32)).to(cuda) for a in (o, d))
    with torch.no_grad():
        model.populate()
        _build.LAUNCHES.clear()
        rendered, _ = model.ray_query(model.ray_test(o, d))
    torch.cuda.synchronize()
    assert dict(_build.LAUNCHES) == {"brick4_fwd": 6, "brick4_dydx": 1,
                                     "gather1d": 1}
    for v in rendered.values():
        assert torch.isfinite(v).all()
