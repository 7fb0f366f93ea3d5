"""Port parity: the MLP-only fields and blocks (ROADMAP A19) and the bf16
options, against the JAX package on the CPU.

* `MlpSDF` at JAX's defaults (D 8, W 256, skip at 4, softplus β = 100):
  JAX's `forward_sdf_nablas` raises `TypeError` (its generic branch passes
  `ho=` to an `_sdf_h` that takes none), asserted here; the port's sdf, h
  and nablas are held against JAX's `forward_sdf` and its `jax.vjp`, and
  the eikonal loss's gradients (second order) against `jax.grad` of that
  composition.
* `MlpNeuS` (JAX's `__call__` raises the same `TypeError`) against the
  working composition: the vjp nablas and JAX's `RadianceNet`.
* `MlpNeRF` at its defaults (D 4, W 128, 6 frequencies): density, rgb and
  the gradients of a loss of both.
* `LipshitzMLP` (values, bound, gradients of ws, bs and cs) and its init's
  cs; `get_blocks`.
* The geometric init at the port's own init: the SDF MLP's layers as
  JAX's scheme lays them out, and sdf ≈ |x| − 0.5 as well as JAX's init
  gets it.
* `MLP` and `LoTDSDF` with `compute_dtype`/`param_dtype` bfloat16 (bf16
  weights across the state bridge): JAX gives bf16 sdf and h and float32
  nablas, and so does the port.

Inputs are float32 from a numpy seed; weights cross by `from_jax_state`.
Tolerances: float32 values within 1e-5 of the largest entry, nablas and
first-order gradients within 1e-4 relative L2, second order within 1e-3
relative L2 (the softplus chain, 8 layers deep); bf16 values within one
bf16 step (2⁻⁸) of the largest entry, and the float32 nablas, which carry
the bf16 roundings of the decoder's backward, within two (2⁻⁷).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from nr3d_lib_tpu.models.blocks import MLP as JMLP
from nr3d_lib_tpu.models.blocks import LipshitzMLP as JLip
from nr3d_lib_tpu.models.fields.nerf import MlpNeRF as JNeRF
from nr3d_lib_tpu.models.fields.neus import MlpNeuS as JNeuS
from nr3d_lib_tpu.models.fields.sdf import LoTDSDF as JLoTDSDF
from nr3d_lib_tpu.models.fields.sdf import MlpSDF as JSDF
from nr3d_lib_tpu_torch.bridge import from_jax_state, to_jax_paths
from nr3d_lib_tpu_torch.models.blocks import (MLP, LipshitzMLP, as_dtype,
                                              get_blocks)
from nr3d_lib_tpu_torch.models.fields import MlpNeRF, MlpNeuS, MlpSDF
from nr3d_lib_tpu_torch.models.fields.sdf import LoTDSDF

torch.set_num_threads(1)

BF16_STEP = 2.0 ** -8


def _flat(module) -> dict:
    return {"/".join(str(p) for p in k): np.asarray(v[...])
            for k, v in nnx.to_flat_state(nnx.state(module))}


def _port(jm, tcls, *args, **kw):
    tm = tcls(*args, **kw, device="cpu")
    tm.load_state_dict(from_jax_state(_flat(jm)))
    return tm


def _x(n: int, seed: int, dim: int = 3):
    return np.random.default_rng(seed).uniform(-1, 1, (n, dim)).astype(
        np.float32)


def _dirs(n: int, seed: int):
    v = np.random.default_rng(seed).normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def _close(got, want, tol: float = 1e-5):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else got
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(float(np.abs(want).max()), 1.0))


def _rel_l2(got, want) -> float:
    return float(np.linalg.norm(got - want) /
                 max(np.linalg.norm(want), 1e-12))


# ------------------------------------------------------------------ MlpSDF
@pytest.fixture(scope="module")
def sdf_pair():
    jm = JSDF(seed=3)
    return jm, _port(jm, MlpSDF)


def _jax_sdf_nablas(jm, x):
    def f(xx):
        out = jm.forward_sdf(xx)
        return out["sdf"], out["h"]
    (sdf, h), vjp_fn = jax.vjp(f, x)
    return sdf, h, vjp_fn((jnp.ones_like(sdf), jnp.zeros_like(h)))[0]


def test_mlp_sdf_nablas_jax_raises_port_matches_vjp(sdf_pair):
    jm, tm = sdf_pair
    x = _x(256, 0)
    with pytest.raises(TypeError, match="ho"):
        jm.forward_sdf_nablas(jnp.asarray(x))
    sdf, h, nablas = _jax_sdf_nablas(jm, jnp.asarray(x))
    out = tm.forward_sdf_nablas(torch.from_numpy(x))
    _close(out["sdf"], sdf)
    _close(out["h"], h)
    assert _rel_l2(out["nablas"].detach().numpy(), np.asarray(nablas)) <= 1e-4
    _close(tm(torch.from_numpy(x)), jm(jnp.asarray(x)))
    with torch.no_grad():                     # detached under no_grad
        assert not tm.forward_sdf_nablas(
            torch.from_numpy(x))["nablas"].requires_grad


def test_mlp_sdf_eikonal_second_order_matches_jax(sdf_pair):
    jm, tm = sdf_pair
    x = _x(128, 1)
    graphdef, params = nnx.split(jm, nnx.Param)

    def loss(p):
        m = nnx.merge(graphdef, p)
        sdf, _, nab = _jax_sdf_nablas(m, jnp.asarray(x))
        return jnp.mean((jnp.linalg.norm(nab, axis=-1) - 1.0) ** 2) + \
            jnp.mean(sdf ** 2)

    want = {"/".join(str(p) for p in k): np.asarray(v[...]) for k, v in
            nnx.to_flat_state(jax.grad(loss)(params))}
    tm.zero_grad(set_to_none=True)
    out = tm.forward_sdf_nablas(torch.from_numpy(x))
    (torch.mean((torch.linalg.norm(out["nablas"], dim=-1) - 1.0) ** 2)
     + torch.mean(out["sdf"] ** 2)).backward()
    got = to_jax_paths({k: p.grad for k, p in tm.named_parameters()})
    assert set(got) == set(want)
    for k in want:
        assert _rel_l2(got[k], want[k]) <= 1e-3, k
    tm.zero_grad(set_to_none=True)


def test_mlp_sdf_entry_point_device():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            MlpSDF(D=1, W=8)
    assert MlpSDF(D=1, W=8, device="cpu").mlp.ws[0].device.type == "cpu"


# ----------------------------------------------------------------- MlpNeuS
def test_mlp_neus_matches_jax_composition():
    jm = JNeuS(surface_cfg={"D": 4, "W": 64, "skips": (2,)}, seed=2)
    tm = _port(jm, MlpNeuS, surface_cfg={"D": 4, "W": 64, "skips": (2,)})
    x, v = _x(256, 2), _dirs(256, 3)
    with pytest.raises(TypeError, match="ho"):
        jm(jnp.asarray(x), jnp.asarray(v))
    sdf, h, nablas = _jax_sdf_nablas(jm.implicit_surface, jnp.asarray(x))
    rgb = jm.radiance(jnp.asarray(x), jnp.asarray(v), nablas, h)
    out = tm(torch.from_numpy(x), torch.from_numpy(v))
    _close(out["sdf"], sdf)
    assert _rel_l2(out["nablas"].detach().numpy(), np.asarray(nablas)) <= 1e-4
    _close(out["rgb"], rgb)
    _close(tm.forward_inv_s(), jm.forward_inv_s())
    only = tm(torch.from_numpy(x), None, with_rgb=False, with_nablas=False)
    assert set(only) == {"sdf", "h"}


# ----------------------------------------------------------------- MlpNeRF
def test_mlp_nerf_matches_jax():
    jm = JNeRF(seed=4)
    tm = _port(jm, MlpNeRF)
    x, v = _x(256, 4), _dirs(256, 5)
    jout = jm(jnp.asarray(x), jnp.asarray(v))
    out = tm(torch.from_numpy(x), torch.from_numpy(v))
    for k in ("sigma", "h", "rgb"):
        _close(out[k], jout[k])
    graphdef, params = nnx.split(jm, nnx.Param)

    def loss(p):
        o = nnx.merge(graphdef, p)(jnp.asarray(x), jnp.asarray(v))
        return jnp.mean(o["sigma"]) + jnp.mean(o["rgb"] ** 2)

    want = {"/".join(str(p) for p in k): np.asarray(val[...]) for k, val in
            nnx.to_flat_state(jax.grad(loss)(params))}
    (torch.mean(out["sigma"]) + torch.mean(out["rgb"] ** 2)).backward()
    got = to_jax_paths({k: p.grad for k, p in tm.named_parameters()})
    assert set(got) == set(want)
    for k in want:
        assert _rel_l2(got[k], want[k]) <= 1e-4, k


# -------------------------------------------------- LipshitzMLP, get_blocks
def _set_state(jm, flat):
    state = nnx.state(jm)
    for k, v in nnx.to_flat_state(state):
        v[...] = jnp.asarray(flat["/".join(str(p) for p in k)])
    nnx.update(jm, state)


def test_lipshitz_mlp_matches_jax():
    """At init every layer sits on the clamp's corner (softplus(c) is the
    weight's bound to the last ulp), where a last-ulp difference picks
    the other side of min(1, ·) and the other gradient: the bounds are
    moved off it, alternately below (the weights scaled) and above."""
    jm = JLip(5, 3, D=3, W=32, seed=6)
    flat = _flat(jm)
    for i in range(4):
        flat[f"cs/{i}"] = flat[f"cs/{i}"] + np.float32(
            -0.3 if i % 2 == 0 else 0.3)
    _set_state(jm, flat)
    tm = _port(jm, LipshitzMLP, 5, 3, D=3, W=32)
    assert tuple(tm.cs[0].shape) == (1,)
    x = _x(128, 7, dim=5)
    _close(tm(torch.from_numpy(x)), jm(jnp.asarray(x)))
    _close(tm.lipshitz_bound_full(), jm.lipshitz_bound_full())
    graphdef, params = nnx.split(jm, nnx.Param)

    def loss(p):
        m = nnx.merge(graphdef, p)
        return jnp.mean(m(jnp.asarray(x)) ** 2) + 0.1 * \
            m.lipshitz_bound_full()

    want = {"/".join(str(p) for p in k): np.asarray(v[...]) for k, v in
            nnx.to_flat_state(jax.grad(loss)(params))}
    (torch.mean(tm(torch.from_numpy(x)) ** 2)
     + 0.1 * tm.lipshitz_bound_full()).backward()
    got = to_jax_paths({k: p.grad for k, p in tm.named_parameters()})
    assert set(got) == set(want)
    for k in want:
        assert _rel_l2(got[k], want[k]) <= 1e-4, k


def test_lipshitz_init_bound_and_clamp():
    """At init each bound softplus(c) equals the weight's largest column
    sum (so the scale is 1 and the net is the plain MLP); a smaller c
    scales the layer down, as JAX's does."""
    tm = LipshitzMLP(4, 2, D=2, W=16, seed=0, device="cpu")
    for w, c in zip(tm.ws, tm.cs):
        bound = torch.nn.functional.softplus(c.detach()[0])
        np.testing.assert_allclose(float(bound), float(
            w.detach().abs().sum(0).amax()), rtol=1e-5)
    jm = JLip(4, 2, D=2, W=16)
    flat = _flat(jm)
    flat["cs/0"] = np.asarray([-3.0], np.float32)
    tm.load_state_dict(from_jax_state(flat))
    _set_state(jm, flat)
    x = _x(32, 8, dim=4)
    _close(tm(torch.from_numpy(x)), jm(jnp.asarray(x)))


@pytest.mark.parametrize("kind", ["mlp", "fcblock", "lipshitz"])
def test_get_blocks_matches_jax(kind):
    from nr3d_lib_tpu.models.blocks import get_blocks as jget

    jm = jget(3, 2, type=kind, D=2, W=8)
    tm = get_blocks(3, 2, type=kind, D=2, W=8, device="cpu")
    assert type(tm).__name__ == type(jm).__name__
    tm.load_state_dict(from_jax_state(_flat(jm)))
    x = _x(16, 9)
    _close(tm(torch.from_numpy(x)), jm(jnp.asarray(x)))
    with pytest.raises(ValueError):
        get_blocks(3, 2, type="tcnn")


# ------------------------------------------------------------ geometric init
def test_geometric_init_layout():
    """JAX's scheme layer by layer: hidden weights N(0, 2/W), zero bias,
    the first layer's rows past xyz zeroed (a frequency-embedded input),
    the last layer's weights √π/√W (+1e-4 noise) and bias −radius."""
    m = MLP(39, 16, D=3, W=256, skips=(2,), activation="softplus",
            geometric_init=True, radius_init=0.7, seed=0,
            device="cpu").requires_grad_(False)
    assert float(m.ws[0][3:].abs().max()) == 0.0
    for i, (w, b) in enumerate(zip(m.ws[:-1], m.bs[:-1])):
        assert float(b.abs().max()) == 0.0
        std = float((w[:3] if i == 0 else w).std())
        assert abs(std / (np.sqrt(2.0) / np.sqrt(256)) - 1.0) < 0.05
    w, b = m.ws[-1], m.bs[-1]
    assert float((w - np.sqrt(np.pi) / np.sqrt(256)).abs().max()) < 1e-3
    assert torch.equal(b, torch.full_like(b, -0.7))


def test_geometric_init_sdf_approximates_sphere():
    """sdf ≈ |x| − 0.5 at the port's own init (JAX's defaults), as well as
    JAX's init gets it on the same seeds: correlation above 0.8 a seed,
    every point with |x| > 0.8 outside, and the mean |sdf − (|x| − 0.5)|
    over four seeds at most 1.25× JAX's."""
    x = _x(4000, 11)
    ref = np.linalg.norm(x, axis=-1) - 0.5
    errs = {"port": [], "jax": []}
    for seed in range(4):
        for side in errs:
            sdf = MlpSDF(seed=seed, device="cpu")(torch.from_numpy(x)) \
                .detach().numpy() if side == "port" else \
                np.asarray(JSDF(seed=seed)(jnp.asarray(x)))
            errs[side].append(np.abs(sdf - ref).mean())
            if side == "port":
                assert np.corrcoef(sdf, ref)[0, 1] > 0.8
                assert (sdf[np.linalg.norm(x, axis=-1) > 0.8] > 0).all()
    assert np.mean(errs["port"]) <= 1.25 * np.mean(errs["jax"])


# -------------------------------------------------------------- bf16 options
BF = {"compute_dtype": jnp.bfloat16, "param_dtype": jnp.bfloat16}
BF_T = {"compute_dtype": torch.bfloat16, "param_dtype": "bfloat16"}


def test_as_dtype():
    assert as_dtype("bfloat16") is torch.bfloat16
    assert as_dtype(torch.float32) is torch.float32 and as_dtype(None) is None
    with pytest.raises(ValueError):
        as_dtype("not_a_dtype")


def test_mlp_bf16_matches_jax():
    jm = JMLP(3, 4, D=2, W=32, skips=(1,), **BF)
    tm = _port(jm, MLP, 3, 4, D=2, W=32, skips=(1,), **BF_T)
    assert tm.ws[0].dtype == torch.bfloat16
    x = _x(256, 12)
    got, want = tm(torch.from_numpy(x)), jm(jnp.asarray(x))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    _close(got, np.asarray(want, np.float32), BF16_STEP)
    # bf16 parameters, float32 compute: as JAX, the weights are upcast
    jm32 = JMLP(3, 4, D=2, W=32, param_dtype=jnp.bfloat16)
    tm32 = _port(jm32, MLP, 3, 4, D=2, W=32, param_dtype=torch.bfloat16)
    got = tm32(torch.from_numpy(x))
    assert got.dtype == torch.float32
    _close(got, jm32(jnp.asarray(x)))


LOTD = {"lod_res": [8, 16, 32], "lod_n_feats": 2,
        "lod_types": ["Dense", "Dense", "Hash"], "hashmap_size": 2 ** 10}


def test_lotd_sdf_bf16_matches_jax():
    jm = JLoTDSDF(encoding_cfg={"lotd_cfg": LOTD, **BF},
                  decoder_cfg={"D": 1, "W": 16, **BF})
    flat = _flat(jm)
    key = "encoding/flattened_params"
    flat[key] = np.random.default_rng(13).uniform(
        -0.1, 0.1, flat[key].shape).astype(flat[key].dtype)
    assert flat[key].dtype.name == "bfloat16"
    _set_state(jm, flat)
    tm = _port(jm, LoTDSDF, encoding_cfg={"lotd_cfg": LOTD, **BF_T},
               decoder_cfg={"D": 1, "W": 16, **BF_T})
    assert tm.encoding.flattened_params.dtype == torch.bfloat16
    x = _x(4096, 14)
    want = _jax_sdf_nablas(jm, jnp.asarray(x))
    out = tm.forward_sdf_nablas(torch.from_numpy(x))
    for k, w in zip(("sdf", "h", "nablas"), want):
        assert str(out[k].dtype).split(".")[-1] == str(w.dtype), k
    assert out["sdf"].dtype == torch.bfloat16
    assert out["nablas"].dtype == torch.float32
    _close(out["sdf"], np.asarray(want[0], np.float32), BF16_STEP)
    _close(out["h"], np.asarray(want[1], np.float32), BF16_STEP)
    _close(out["nablas"], want[2], 2 * BF16_STEP)
    # the encoding alone, both ways of building it
    enc = tm.encoding
    np.testing.assert_array_equal(
        enc(torch.from_numpy(x)).detach().float().numpy(),
        np.asarray(jm.encoding(jnp.asarray(x)), np.float32))
