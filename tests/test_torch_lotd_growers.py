"""Port parity: the LoTD growers (`lotd_growers.py`) against the JAX
package's on the CPU.

Each grower type is built in JAX, its state carried into the port's by
the state bridge (names map one to one: `mlp/ws/i`, `trunk/i/w`,
`heads/i/wz`, `pseudo/<level>`, `shared`, `const`, `blocks/i/w`, `base`,
`growers/i/...`; `w` is [in, out] in both), and both grow params from
the same latent codes, with and without `max_level`; the grown params
then go through `lotd_encode(..., bidx=)` on both sides. The conv
grower's resize (`resize_trilinear`, `jax.image.resize(..., "trilinear")`
with its antialiasing) is held against JAX directly, up and down.

Tolerances: the growers are small matmuls and resizes summed in another
order: within 1e-5 of the largest entry (the resize within 1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from nr3d_lib_tpu.models.grid_encodings.lotd import lotd_growers as JG
from nr3d_lib_tpu.ops import lotd as JL
from nr3d_lib_tpu_torch.bridge import from_jax_state
from nr3d_lib_tpu_torch.models.grid_encodings.lotd import lotd_growers as TG
from nr3d_lib_tpu_torch.ops import lotd as TL

torch.set_num_threads(1)

Z_DIM = 6
B = 3
MIXED_META = dict(lod_res=[5, [6, 4, 7], 9, 12], lod_n_feats=[2, 2, 4, 2],
                  lod_types=["Dense", "VM", "CP", "Hash"], hashmap_size=128)
DENSE_META = dict(lod_res=[4, [6, 5, 7], 9], lod_n_feats=2,
                  lod_types=["Dense", "Dense", "Hash"], hashmap_size=1024)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rel):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    err = float(np.abs(np.asarray(got, np.float64) - want).max())
    assert err <= rel * max(float(np.abs(want).max()), 1e-12), err


def _metas(kw):
    return (JL.generate_meta(3, kw["lod_res"], kw["lod_n_feats"],
                             kw["lod_types"], hashmap_size=kw["hashmap_size"]),
            TL.generate_meta(3, kw["lod_res"], kw["lod_n_feats"],
                             kw["lod_types"], hashmap_size=kw["hashmap_size"]))


GROWERS = [
    ("flatten", MIXED_META, dict(D=1, W=16)),
    ("fmm", MIXED_META, dict(D=2, W=8)),
    ("fmm", DENSE_META, dict(D=1, W=8, use_shared_encoding=False,
                             activation="softplus")),
    ("conv", DENSE_META, dict(base_channels=4)),
    ("shared_mod", MIXED_META, dict()),
    ("mixed", MIXED_META, dict(splits=[(2, "fmm", {"D": 1, "W": 8}),
                                       (1, "flatten", {"D": 1, "W": 8}),
                                       (1, "shared_mod", {})])),
]


@pytest.mark.parametrize("kind,meta_kw,kw", GROWERS,
                         ids=[f"{k}{i}" for i, (k, _, _) in
                              enumerate(GROWERS)])
def test_grower_matches_jax(kind, meta_kw, kw):
    mj, mt = _metas(meta_kw)
    jg = JG.get_lotd_grower(kind, Z_DIM, mj, seed=2, **kw)
    tg = TG.get_lotd_grower(kind, Z_DIM, mt, seed=2, device="cpu", **kw)
    rng = np.random.default_rng(3)
    flat = {}
    for k, v in nnx.to_flat_state(nnx.state(jg, nnx.Param)):
        a = np.asarray(v[...])
        # every weight random, so zero-initialised biases take part too
        flat["/".join(map(str, k))] = (a + rng.normal(size=a.shape) * 0.1
                                       ).astype(np.float32)
    state = nnx.state(jg, nnx.Param)
    for k, v in nnx.to_flat_state(state):
        v[...] = jnp.asarray(flat["/".join(map(str, k))])
    nnx.update(jg, state)
    tg.load_state_dict(from_jax_state(flat))
    z = rng.normal(size=(B, Z_DIM)).astype(np.float32)
    for ml in (1, None):
        pj = nnx.jit(lambda g, zz: g(zz, max_level=ml))(jg, jnp.asarray(z))
        pt = tg(_t(z), max_level=ml)
        assert pt.shape == (B, mt.n_params)
        _close(pt, pj, 1e-5)
    # the grown params through the batched encode
    x = rng.uniform(0, 1, (64, 3)).astype(np.float32)
    bidx = rng.integers(-1, B, 64).astype(np.int32)
    yj = JL.lotd_encode(jnp.asarray(x), pj, mj, bidx=jnp.asarray(bidx))
    yt = TL.lotd_encode(_t(x), pt, mt, bidx=_t(bidx))
    _close(yt, yj, 1e-5)
    # gradients reach every weight through the encode
    (yt ** 2).sum().backward()
    assert all(p.grad is not None for p in tg.parameters())


@pytest.mark.parametrize("src,dst", [((4, 5, 6), (8, 10, 12)),
                                     ((8, 10, 12), (3, 7, 5)),
                                     ((6, 4, 9), (6, 9, 2))],
                         ids=["up", "down", "mixed"])
def test_resize_trilinear_matches_jax(src, dst):
    """Half-pixel centres, and antialiasing on the axes that shrink."""
    h = np.random.default_rng(4).normal(size=(2,) + src + (3,)
                                        ).astype(np.float32)
    want = jax.image.resize(jnp.asarray(h), (2,) + dst + (3,), "trilinear")
    got = TG.resize_trilinear(_t(h), (2,) + dst + (3,))
    assert got.shape == (2,) + dst + (3,)
    _close(got, want, 1e-6)
    if src[0] < dst[0]:
        # upsampling is F.interpolate's trilinear with half-pixel centres
        ref = torch.nn.functional.interpolate(
            _t(h).permute(0, 4, 1, 2, 3), size=dst, mode="trilinear",
            align_corners=False).permute(0, 2, 3, 4, 1)
        _close(got, ref.numpy(), 1e-6)


def test_level_entry_coords_match_jax():
    mj, mt = _metas(MIXED_META)
    for lv in range(mj.n_levels):
        cj, ct = JG._level_entry_coords(mj, lv), TG._level_entry_coords(mt,
                                                                       lv)
        assert (cj is None) == (ct is None)
        if cj is not None:
            np.testing.assert_array_equal(ct, cj)
            assert ct.shape[0] == mt.level_sizes[lv]


def test_unknown_grower_and_conv_meta_raise():
    mj, mt = _metas(MIXED_META)
    with pytest.raises(ValueError, match="Unknown grower"):
        TG.get_lotd_grower("bogus", Z_DIM, mt)
    with pytest.raises(ValueError, match="dense"):
        TG.LoTDConvGrower(Z_DIM, mt, device="cpu")
