"""The host side of the cell kernels' simplex search: the per-level
modulus constants that `c_meta` hands the kernels (`pc_mod` in
`csrc/permuto_simplex.cuh`), what `c_meta` refuses, and the count of the
table-gradient atomics that the backward's warp aggregation leaves
(`atomic_groups`). The kernels themselves run only on a card
(`tests/test_torch_kernels_gpu.py`)."""

import numpy as np
import pytest
import torch

from nr3d_lib_tpu_torch.ops import permuto_cell as PC

METAS = {"pathc": (4, [4.0, 11.0, 32.0, 90.0], 4096),
         "pathd": (4, [8.0, 16.0, 32.0, 64.0, 128.0], 4096),
         "bench3d": (3, [16.0 * 2 ** (0.5 * i) for i in range(8)], 4096)}
U32 = (1 << 32) - 1


def _pc_mod(h: np.ndarray, m: int, magic: int, sh1: int, sh2: int):
    """`pc_mod` in numpy uint64: every product of two 32-bit values fits."""
    h = h.astype(np.uint64)
    t = (h * np.uint64(magic)) >> np.uint64(32)
    q = (t + ((h - t) >> np.uint64(sh1))) >> np.uint64(sh2)
    return h - q * np.uint64(m)


def _hashes(m: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.concatenate([np.asarray([0, m - 1, m, U32], np.uint64),
                           rng.integers(0, U32, 100_000, np.uint64,
                                        endpoint=True)])


@pytest.mark.parametrize("name", sorted(METAS))
def test_level_modulus_constants_are_exact(name):
    meta = PC.make_permuto_cell_meta(*METAS[name])
    cm = PC.c_meta(meta)
    for i, lv in enumerate(meta.levels):
        c = cm.lv[i]
        m = lv.n_rows * meta.cells_per_row
        assert c.hash_mod == m and 0 < c.mod_magic <= U32
        h = _hashes(m, i)
        np.testing.assert_array_equal(
            _pc_mod(h, m, c.mod_magic, c.mod_sh1, c.mod_sh2), h % np.uint64(m))


def test_modulus_constants_are_exact_for_any_modulus():
    rng = np.random.default_rng(3)
    ms = [1, 2, 3, 5, 7, 1 << 13, (1 << 24) - 1, 1 << 24, (1 << 31) - 1,
          1 << 31, U32] + [int(v) for v in rng.integers(1, (1 << 24) + 1, 64)]
    for j, m in enumerate(ms):
        magic, sh1, sh2 = PC.fastmod_constants(m)
        assert 0 < magic <= U32 and (sh1, sh2) == (
            min((m - 1).bit_length(), 1), max((m - 1).bit_length() - 1, 0))
        h = _hashes(m, 100 + j)
        np.testing.assert_array_equal(_pc_mod(h, m, magic, sh1, sh2),
                                      h % np.uint64(m))
    for bad in (0, 1 << 32):
        with pytest.raises(ValueError, match="modulus"):
            PC.fastmod_constants(bad)


def test_c_meta_refuses_other_cells_per_row():
    meta = PC.make_permuto_cell_meta(3, [2.0, 8.0], 64)
    meta.__dict__["cells_per_row"] = 2           # the kernels take 2^(5-d)
    with pytest.raises(ValueError, match="cells per row"):
        PC.c_meta(meta)


def test_c_meta_refuses_slots_past_int32():
    ok = PC.make_permuto_cell_meta(4, [90.0], (1 << 25) - 1, auto_dense=False)
    assert PC.c_meta(ok).lv[0].hash_mod == ((1 << 25) - 1) * 2
    big = PC.make_permuto_cell_meta(4, [90.0], 1 << 25, auto_dense=False)
    with pytest.raises(ValueError, match="int32"):
        PC.c_meta(big)


def _points(d: int, n: int, seed: int) -> torch.Tensor:
    """Points along rays, 96 a ray, sorted along each; coordinates past
    the third constant along a ray (the dynamic field's time)."""
    r = np.random.default_rng(seed)
    rays = -(-n // 96)
    o = r.uniform(0.0, 1.0, (rays, 1, d))
    v = r.normal(size=(rays, 1, d))
    v[..., 3:] = 0.0
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    t = np.sort(r.uniform(0.0, 0.8, (rays, 96, 1)), 1)
    x = np.clip(o + v * t, 0.0, 1.0).reshape(-1, d)[:n]
    return torch.from_numpy(x.astype(np.float32))


@pytest.mark.parametrize("name", ["pathc", "bench3d"])
def test_atomic_groups_match_brute_force(name):
    """The distinct (warp, slot) pairs, against sets built lane by lane
    and vertex by vertex, with a ragged last warp and in a permuted
    order."""
    meta = PC.make_permuto_cell_meta(*METAS[name])
    x = _points(meta.n_dims, 1000, 5)
    for xx in (x, x[torch.randperm(len(x),
                                   generator=torch.Generator().manual_seed(1))]):
        got = PC.atomic_groups(xx, meta)
        want = []
        for lv in meta.levels:
            vtx = PC._level_vertices(xx, lv, meta)[0].tolist()
            want.append(sum(len({vtx[p][k] for p in range(w, min(w + 32,
                                                                 len(xx)))
                                 for k in range(meta.n_dims + 1)})
                            for w in range(0, len(xx), 32)))
        assert got == want
        assert all(g <= len(xx) * (meta.n_dims + 1) for g in got)
    # along rays the coarse levels share slots within a warp
    assert got[0] > PC.atomic_groups(x, meta)[0]
