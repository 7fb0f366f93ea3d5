"""The budgeted occupancy march (`ops.occgrid_march.occgrid_march_budgeted`,
`OccGridAccel.ray_march_budgeted`) on the CPU, where it is the plain route.

Its plain route is the dense march, the ray mask and `dense_to_budgeted`;
it also equals a walk along each ray that keeps the first B occupied
steps, the fused kernel's algorithm (`csrc/occ_march.cu`, held bitwise to
the dense route on the card in `test_torch_kernels_gpu.py`). The three
compressed queries march through `ray_march_budgeted` with their budget,
mask and jitter; the other modes march dense. The `fused` counter of the
`query.march` span: 0 on the plain route, charged by `mark_fused` to the
innermost open span.
"""

import numpy as np
import pytest
import torch

from nr3d_lib_tpu_torch import profile as PR
from nr3d_lib_tpu_torch.graphics.pack_ops import dense_to_budgeted
from nr3d_lib_tpu_torch.models.accelerations.occgrid_accel import \
    OccGridAccel
from nr3d_lib_tpu_torch.models.model_base import LoTDNeRFModel, LoTDNeuSModel
from nr3d_lib_tpu_torch.ops import occgrid_march as OM

torch.set_num_threads(1)

# name → (budget, occupied share, jitter, mask, dt_gamma, max_step_size)
CASES = {
    "budget_past_count": (64, 0.1, False, False, 0.0, None),
    "budget_under_count": (6, 0.7, False, False, 0.0, None),
    "masked_rows": (8, 0.4, False, True, 0.0, None),
    "jitter": (8, 0.4, True, False, 0.0, None),
    "jitter_masked": (12, 0.7, True, True, 0.0, None),
    "gamma_max_step": (10, 0.5, True, False, 0.05, 0.08),
    "gamma_uncapped": (10, 0.5, False, True, 0.03, None),
    "budget_one": (1, 0.3, False, True, 0.0, None),
}


def _inputs(n: int, s: int, occ_p: float, jitter: bool, masked: bool,
            seed: int = 0):
    g = torch.Generator().manual_seed(seed)
    occ = torch.rand((8, 10, 12), generator=g) < occ_p
    o = (torch.rand((n, 3), generator=g) * 2 - 1) * 1.2
    d = torch.randn((n, 3), generator=g)
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    near = torch.rand(n, generator=g) * 0.3
    far = near + torch.rand(n, generator=g) * 3.0
    far[: n // 8] = near[: n // 8] - 0.1                 # near >= far
    mask = torch.rand(n, generator=g) > 0.3 if masked else None
    u = torch.rand((n, s), generator=g) if jitter else None
    return occ, o, d, near, far, mask, u


def _walk(occ, o, d, near, far, mask, u, s, step, gamma, max_step, budget):
    """Each ray's steps in order, the first `budget` in range and
    occupied kept (the kernel's algorithm, with the dense route's float32
    operations)."""
    t0, dts = (a.numpy() for a in OM.step_table(s, step, gamma, max_step))
    f32 = np.float32
    res = occ.shape
    occ, o, d = occ.numpy(), o.numpy(), d.numpy()
    near, far = near.numpy(), far.numpy()
    n = o.shape[0]
    t_out = np.zeros((n, budget), f32)
    dt_out = np.zeros((n, budget), f32)
    valid = np.zeros((n, budget), bool)
    for r in range(n):
        if mask is not None and not bool(mask[r]):
            continue
        k = 0
        for i in range(s):
            t_start = f32(t0[i] + near[r])
            w = f32(0.5) if u is None else u[r, i].item()
            t = f32(t_start + f32(f32(w) * dts[i]))
            if not (t < far[r] and t_start >= f32(near[r] - f32(1e-9))):
                continue
            idx = [int(np.floor(f32(f32(f32(f32(o[r, a] + f32(d[r, a] * t))
                                             + f32(1.0)) * f32(0.5))
                                    * f32(res[a])))) for a in range(3)]
            if any(j < 0 or j >= res[a] for a, j in enumerate(idx)):
                continue
            if not occ[tuple(idx)]:
                continue
            t_out[r, k], dt_out[r, k], valid[r, k] = t, dts[i], True
            k += 1
            if k == budget:
                break
    return [torch.from_numpy(a) for a in (t_out, dt_out, valid)]


@pytest.mark.parametrize("case", sorted(CASES))
def test_budgeted_plain_is_the_dense_chain(case):
    budget, occ_p, jitter, masked, gamma, max_step = CASES[case]
    s, step = 40, 0.05
    occ, o, d, near, far, mask, u = _inputs(300, s, occ_p, jitter, masked)
    kw = dict(n_steps=s, step_size=step, dt_gamma=gamma,
              max_step_size=max_step, u=u)
    t, dt, valid = OM.occgrid_march_budgeted(occ, o, d, near, far, **kw,
                                             budget=budget, ray_mask=mask)
    td, dtd, m = OM.occgrid_march_dense(occ, o, d, near, far, **kw)
    if mask is not None:
        m = m & mask[:, None]
    (tw, dtw), vw = dense_to_budgeted([td, dtd], m, budget)
    for a, b in zip((t, dt, valid), (tw, dtw, vw)):
        assert torch.equal(a, b)
    # the kernel's walk along each ray gives the same slots
    for a, b in zip((t, dt, valid), _walk(occ, o, d, near, far, mask, u, s,
                                          step, gamma, max_step, budget)):
        assert torch.equal(a, b)
    counts = m.sum(-1)
    assert torch.equal(valid.sum(-1), torch.clamp(counts, max=budget))
    assert not bool(valid[: 300 // 8].any())         # near >= far
    if mask is not None:
        assert not bool(valid[~mask].any())
    if budget < 40:
        assert int((counts > budget).sum()) > 0, "no row past the budget"


def test_accel_ray_march_budgeted_is_the_dense_chain():
    """`OccGridAccel.ray_march_budgeted` marches the accel's grid with its
    step settings, jittered or at the midpoints."""
    accel = OccGridAccel(resolution=(16, 16, 16), step_size=2.0 / 48,
                         max_steps_per_ray=48, dt_gamma=0.01,
                         max_step_size=0.06, device="cpu")
    g = torch.Generator().manual_seed(4)
    accel.occ.val_grid.copy_(torch.rand((16, 16, 16), generator=g))
    _, o, d, near, far, mask, u = _inputs(200, 48, 0.5, True, True, seed=4)
    for uu in (u, None):
        got = accel.ray_march_budgeted(o, d, near, far, 12, u=uu,
                                       ray_mask=mask)
        t, dt, m = accel.ray_march(o, d, near, far, u=uu)
        (t, dt), valid = dense_to_budgeted([t, dt], m & mask[:, None], 12)
        for a, b in zip(got, (t, dt, valid)):
            assert torch.equal(a, b)
        assert int(valid.sum()) > 0


ACCEL = {"resolution": 16, "max_steps_per_ray": 32, "step_size": 2.0 / 32}
ENC = {"lotd_cfg": {"lod_res": [16, 64], "lod_n_feats": 4,
                    "lod_types": ["Dense", "Hash"], "hashmap_size": 2 ** 16},
       "backend": "brick", "hashmap_rows": 64}
NEUS_FIELD = {"surface_cfg": {"encoding_cfg": ENC,
                              "decoder_cfg": {"D": 1, "W": 16}},
              "radiance_cfg": {"D": 2, "W": 16}}
NERF_FIELD = {"encoding_cfg": ENC, "density_decoder_cfg": {"D": 1, "W": 16},
              "radiance_cfg": {"D": 2, "W": 16}}
# (model, query config) → the budget its march keeps (None: dense march)
MODES = {
    "nerf_march_occ": ("nerf", {"query_mode": "march_occ"}, None),
    "nerf_compressed": ("nerf", {"query_mode": "march_occ_compressed"}, 8),
    "nerf_multi_upsample_compressed": (
        "nerf", {"query_mode": "march_occ_multi_upsample_compressed",
                 "n_fine": 8, "compression_factor": 0.5}, 16),
    "neus_compressed_budget": (
        "neus", {"query_mode": "march_occ_multi_upsample_compressed",
                 "march_budget_factor": 0.5, "n_importance": 8}, 16),
    "neus_compressed_no_budget": (
        "neus", {"query_mode": "march_occ_multi_upsample_compressed",
                 "n_importance": 8}, None),
    "neus_multi_upsample": (
        "neus", {"query_mode": "march_occ_multi_upsample",
                 "n_importance": 8}, None),
}


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("perturbed", [False, True])
def test_compressed_queries_march_budgeted(monkeypatch, mode, perturbed):
    """The three compressed queries (the NeuS one with a march budget)
    march through `ray_march_budgeted` once, with their budget, the NeRF
    ones with the ray mask, the jitter where perturbed; the other modes
    march dense and never call it. Either way the `query.march` span
    charges `fused` 0 on the CPU."""
    kind, query, budget = MODES[mode]
    calls = {"dense": [], "budgeted": []}
    dense, budgeted = OccGridAccel.ray_march, OccGridAccel.ray_march_budgeted

    def spy_dense(self, *a, **kw):
        calls["dense"].append(kw)
        return dense(self, *a, **kw)

    def spy_budgeted(self, *a, **kw):
        calls["budgeted"].append((a, kw))
        return budgeted(self, *a, **kw)

    monkeypatch.setattr(OccGridAccel, "ray_march", spy_dense)
    monkeypatch.setattr(OccGridAccel, "ray_march_budgeted", spy_budgeted)
    if kind == "nerf":
        model = LoTDNeRFModel(field_cfg=NERF_FIELD, accel_cfg=ACCEL,
                              ray_query_cfg=query, device="cpu")
    else:
        model = LoTDNeuSModel(field_cfg=NEUS_FIELD, accel_cfg=ACCEL,
                              ray_query_cfg=query, device="cpu")
    model.populate()
    g = torch.Generator().manual_seed(2)
    o = torch.randn((48, 3), generator=g)
    o = o / torch.linalg.norm(o, dim=-1, keepdim=True) * 2.0
    d = -o / 2.0 + torch.randn((48, 3), generator=g) * 0.2
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    rt = model.ray_test(o, d)
    with torch.no_grad():
        rendered, _ = model.ray_query(
            rt, generator=torch.Generator().manual_seed(3)
            if perturbed else None)
    assert all(torch.isfinite(v).all() for v in rendered.values())
    if budget is None:
        assert len(calls["dense"]) == 1 and calls["budgeted"] == []
        return
    assert calls["dense"] == [] and len(calls["budgeted"]) == 1
    a, kw = calls["budgeted"][0]
    assert a[4] == budget
    u = kw.get("u")
    assert (u is not None) == perturbed
    if perturbed:
        assert u.shape == (48, 32)
    if kind == "nerf":
        assert kw["ray_mask"] is rt["mask"]
    else:
        assert kw.get("ray_mask") is None
    march = [s for s in PR.spans() if s.name == "query.march"][-1]
    assert march.fused == 0


def test_mark_fused_charges_the_innermost_span():
    PR.mark_fused()                      # no span open: charged to none
    with PR.profile("outer"):
        PR.mark_fused()
        with PR.profile("inner"):
            PR.mark_fused()
            PR.mark_fused()
            PR.mark_fused()
        with PR.profile("quiet"):
            pass
    inner, quiet, outer = PR.spans()[-3:]
    assert [(s.name, s.fused) for s in (inner, quiet, outer)] == \
        [("inner", 3), ("quiet", 0), ("outer", 1)]
