"""Port parity: `models/tetrahedral.py` (`make_tet_grid`,
`marching_tets_jax`, `DMTet` and `to_mesh`) against the JAX package on
the CPU.

* The grid equal to JAX's (vertices bitwise, the same tets in the same
  order) at resolutions 2, 5 and 12, over the default and a skewed box.
* DMTet at resolution 12 over an analytic SDF (a sphere of radius 0.5,
  and with a seeded deformation): `mask_bits` and `tri_mask` equal,
  `tri_verts` within 1e-6, the gradients of JAX's test loss (Σ over the
  valid corners of (|v| − 0.4)²) in the SDF values and the deformation
  within 1e-5 relative L2 of `jax.grad`, `to_mesh` equal (deformed: its
  face count; tanh differs by an ulp between XLA and torch).
* DMTet over a small F=4 brick `LoTDSDF` (`lod_res` [8, 16], tables in
  ±0.1, weights from a bridged JAX state), its level set at the median
  of JAX's values: the SDF values within 1e-5, the masks equal, and one
  step's gradient in the table within 1e-5 relative L2. The grid's
  positions carry no gradient, so the encode's backward takes the table's
  alone (`brick4_encode_frozen_x` at F=4; B2 without dL/dx on the card).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from nr3d_lib_tpu.models import tetrahedral as J
from nr3d_lib_tpu.models.fields.sdf import LoTDSDF as JLoTDSDF
from nr3d_lib_tpu_torch.bridge import from_jax_state
from nr3d_lib_tpu_torch.models import tetrahedral as T
from nr3d_lib_tpu_torch.models.fields.sdf import LoTDSDF


def _rel(got, want) -> float:
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-12))


@pytest.mark.parametrize("res", [2, 5, 12])
@pytest.mark.parametrize("box", [((-1.0,) * 3, (1.0,) * 3),
                                 ((-0.5, 0.0, -2.0), (1.5, 0.25, 1.0))],
                         ids=["unit", "skewed"])
def test_make_tet_grid_matches_jax(res, box):
    vj, tj = J.make_tet_grid(res, *box)
    vt, tt = T.make_tet_grid(res, *box, device="cpu")
    assert vt.dtype == torch.float32 and tt.dtype == torch.int32
    assert tt.shape == (6 * (res - 1) ** 3, 4)
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(tj))


def _surf_loss_j(dm):
    def loss(s, d):
        tv, m, _ = dm(s, d)
        r = jnp.linalg.norm(tv, axis=-1)
        return jnp.sum(jnp.where(m[..., None], (r - 0.4) ** 2, 0.0))
    return loss


def _surf_loss_t(tv, m):
    r = torch.linalg.norm(tv, dim=-1)
    return torch.sum(torch.where(m[..., None], (r - 0.4) ** 2,
                                 torch.zeros_like(r)))


@pytest.mark.parametrize("deformed", [False, True])
def test_dmtet_analytic_sphere(deformed):
    dm_j = J.DMTet(resolution=12)
    dm_t = T.DMTet(resolution=12, device="cpu")
    base = np.asarray(dm_j.base_verts)
    sdf = (np.linalg.norm(base, axis=-1) - 0.5).astype(np.float32)
    deform = (np.random.default_rng(0).normal(size=base.shape) * 0.5
              if deformed else np.zeros_like(base)).astype(np.float32)
    tv_j, m_j, b_j = dm_j(jnp.asarray(sdf), jnp.asarray(deform))
    s = torch.from_numpy(sdf).requires_grad_(True)
    d = torch.from_numpy(deform).requires_grad_(True)
    tv_t, m_t, b_t = dm_t(s, d)
    np.testing.assert_array_equal(b_t.numpy(), np.asarray(b_j))
    np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_j))
    np.testing.assert_allclose(tv_t.detach().numpy(), np.asarray(tv_j),
                               rtol=0, atol=1e-6)
    assert 0 < int(m_t.sum()) < m_t.numel()
    _surf_loss_t(tv_t, m_t).backward()
    g_s, g_d = jax.grad(_surf_loss_j(dm_j), argnums=(0, 1))(
        jnp.asarray(sdf), jnp.asarray(deform))
    assert _rel(s.grad.numpy(), np.asarray(g_s)) <= 1e-5
    assert _rel(d.grad.numpy(), np.asarray(g_d)) <= 1e-5
    mesh_t, mesh_j = dm_t.to_mesh(tv_t, m_t), dm_j.to_mesh(tv_j, m_j)
    if deformed:
        # tanh differs by an ulp between XLA and torch: a vertex may round
        # to the other side of a 6th decimal, so only the faces' count
        assert mesh_t[1].shape == mesh_j[1].shape
        return
    for a, b in zip(mesh_t, mesh_j):
        np.testing.assert_array_equal(a, b)
    assert abs(np.median(np.linalg.norm(mesh_t[0], axis=-1)) - 0.5) < 0.05


LOTD4 = {"lotd_cfg": {"lod_res": [8, 16], "lod_n_feats": 4,
                      "lod_types": ["Dense", "Hash"], "hashmap_size": 2 ** 12},
         "backend": "brick", "hashmap_rows": 64}
TABLE = "encoding/flattened_params"


def _flat(state) -> dict:
    return {"/".join(str(p) for p in k): np.asarray(v[...])
            for k, v in nnx.to_flat_state(state)}


@pytest.fixture(scope="module")
def sdf_pair():
    jm = JLoTDSDF(encoding_cfg=LOTD4, decoder_cfg={"D": 1, "W": 16})
    flat = _flat(nnx.state(jm))
    flat[TABLE] = np.random.default_rng(1).uniform(
        -0.1, 0.1, flat[TABLE].shape).astype(np.float32)
    state = nnx.state(jm)
    for k, v in nnx.to_flat_state(state):
        v[...] = jnp.asarray(flat["/".join(str(p) for p in k)])
    nnx.update(jm, state)
    tm = LoTDSDF(encoding_cfg=LOTD4, decoder_cfg={"D": 1, "W": 16},
                 device="cpu")
    tm.load_state_dict(from_jax_state(flat))
    return jm, tm


def test_dmtet_over_brick_sdf(sdf_pair):
    jm, tm = sdf_pair
    dm_j = J.DMTet(resolution=12)
    dm_t = T.DMTet(resolution=12, device="cpu")
    graphdef, params, rest = nnx.split(jm, nnx.Param, ...)
    level = float(np.median(np.asarray(
        jm.forward_sdf(dm_j.base_verts)["sdf"])))

    def jloss(p):
        m = nnx.merge(graphdef, p, rest)
        s = m.forward_sdf(dm_j.base_verts)["sdf"] - level
        return _surf_loss_j(dm_j)(s, None), s

    (lj, sdf_j), g = jax.value_and_grad(jloss, has_aux=True)(params)
    sdf_t = tm.forward_sdf(dm_t.base_verts)["sdf"] - level
    np.testing.assert_allclose(sdf_t.detach().numpy(), np.asarray(sdf_j),
                               rtol=0, atol=1e-5)
    tv_t, m_t, b_t = dm_t(sdf_t)
    # where no value lies within 1e-5 of the level set, the cases agree
    near = np.abs(np.asarray(sdf_j)) < 1e-5
    assert not near.any()
    _, m_j, b_j = dm_j(sdf_j)
    np.testing.assert_array_equal(b_t.numpy(), np.asarray(b_j))
    np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_j))
    assert 0 < int(m_t.sum())
    lt = _surf_loss_t(tv_t, m_t)
    lt.backward()
    assert abs(float(lt.detach()) - float(lj)) <= 1e-5 * abs(float(lj))
    want = np.asarray(_flat(g)[TABLE])
    got = tm.encoding.flattened_params.grad.numpy()
    assert _rel(got, want) <= 1e-5
