"""The count of the table-gradient atomics that the F=2 brick encode's
backward (B7, `csrc/brick.cu` `brick_bwd`) and the nablas' backward (B9,
`brick_bwd2`) each issue once their warps sum, corner by corner, the
lanes that add to one slot (`ops/lotd_brick.brick_atomic_groups`). The
kernels themselves run only on a card (`tests/test_torch_kernels_gpu.py`);
this holds the host-side count that `chip_ab.py` and `chip_smoke.py`
report beside their times."""

import numpy as np
import pytest
import torch

from nr3d_lib_tpu_torch.ops import lotd_brick as B

# a dense and a hashed level of the F=2 NeuS's kind, and eight levels
# (the most the kernels take) with hashed levels of 256 rows
METAS = {"dense_hash": ([16, 32, 64, 128], ["Dense", "Dense", "Hash",
                                            "Hash"], 4096),
         "eight_levels": ([8, 12, 16, 24, 32, 48, 64, 96],
                          ["Dense"] * 3 + ["Hash"] * 5, 256)}


def _ray_points(n: int, seed: int) -> torch.Tensor:
    """Points in [0,1]^3 along seeded rays, 96 a ray, sorted along each,
    as a render's sample slab."""
    r = np.random.default_rng(seed)
    rays = -(-n // 96)
    o = r.uniform(0.0, 1.0, (rays, 1, 3))
    v = r.normal(size=(rays, 1, 3))
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    t = np.sort(r.uniform(0.0, 0.8, (rays, 96, 1)), 1)
    x = np.clip(o + v * t, 0.0, 1.0).reshape(-1, 3)[:n]
    return torch.from_numpy(x.astype(np.float32))


def _brute_force(x: torch.Tensor, meta, warp: int):
    """One set of slots per (warp, corner), built point by point."""
    offs = [((k >> 2) & 1) * 16 + ((k >> 1) & 1) * 4 + (k & 1)
            for k in range(8)]
    out = []
    for lv in meta.levels:
        row, lane0, _ = B._level_rows_and_lanes(x, lv)
        base = (row * 64 + lane0 // 2).tolist()
        out.append(sum(
            len({base[p] + offs[k] for p in range(w, min(w + warp, len(x)))})
            for w in range(0, len(x), warp) for k in range(8)))
    return out


@pytest.mark.parametrize("name", sorted(METAS))
def test_brick_atomic_groups_match_brute_force(name):
    """Dense and hashed levels, n not a multiple of 32 (a ragged last
    warp), ray order and permuted."""
    meta = B.make_brick_meta(*METAS[name])
    assert {lv.kind for lv in meta.levels} == {"dense", "hash"}
    x = _ray_points(1000, 3)
    perm = torch.randperm(len(x), generator=torch.Generator().manual_seed(4))
    for xx in (x, x[perm]):
        got = B.brick_atomic_groups(xx, meta)
        assert got == _brute_force(xx, meta, 32)
        assert all(g <= len(xx) * 8 for g in got)


@pytest.mark.parametrize("name", sorted(METAS))
@pytest.mark.parametrize("n", [1, 31, 33, 1000])
def test_brick_atomic_groups_one_lane_issues_all(name, n):
    """A warp of one lane issues every (point, level, corner) atomic."""
    meta = B.make_brick_meta(*METAS[name])
    x = _ray_points(n, 5)
    assert sum(B.brick_atomic_groups(x, meta, warp=1)) == \
        n * meta.n_levels * 8


@pytest.mark.parametrize("name", sorted(METAS))
@pytest.mark.parametrize("seed", [6, 7])
def test_brick_atomic_groups_ray_order_needs_no_more(name, seed):
    """Along rays a warp's lanes share slots, most at the coarse levels:
    ray order never needs more atomics than the same points permuted."""
    meta = B.make_brick_meta(*METAS[name])
    x = _ray_points(96 * 40, seed)
    perm = torch.randperm(len(x),
                          generator=torch.Generator().manual_seed(seed))
    ray, shuffled = (B.brick_atomic_groups(xx, meta) for xx in (x, x[perm]))
    assert all(a <= b for a, b in zip(ray, shuffled))
    assert ray[0] < shuffled[0]


def _b7_launch(x: torch.Tensor, meta):
    """B7's launch simulated thread by thread: block b takes the points
    [32b, 32b + 32) at all L levels (blockDim = 32 L), thread 32 l + i
    the point 32b + i at level l; a warp is 32 consecutive threads of a
    block, and corner by corner it issues one atomic for each distinct
    slot among its lanes that hold a point. Per level, the atomics."""
    offs = [((k >> 2) & 1) * 16 + ((k >> 1) & 1) * 4 + (k & 1)
            for k in range(8)]
    L, n = meta.n_levels, len(x)
    base = []
    for lv in meta.levels:
        row, lane0, _ = B._level_rows_and_lanes(x, lv)
        base.append((row * 64 + lane0 // 2).tolist())
    out = [0] * L
    for b in range(-(-n // 32)):
        for w in range(L):                       # the block's warps
            lanes = [(tau >> 5, tau & 31) for tau in range(32 * w,
                                                           32 * w + 32)]
            for k in range(8):
                keys = {(l, base[l][32 * b + i] + offs[k]) for l, i in lanes
                        if 32 * b + i < n}
                for l, _ in keys:
                    out[l] += 1
    return out


@pytest.mark.parametrize("name", sorted(METAS))
@pytest.mark.parametrize("n", [1, 31, 33, 1000])
def test_b7_issues_what_brick_atomic_groups_counts(name, n):
    """B7's level-major warps issue, at ray order and permuted, the count
    that `brick_atomic_groups` gives for B9 at the same points."""
    meta = B.make_brick_meta(*METAS[name])
    x = _ray_points(n, 8)
    perm = torch.randperm(n, generator=torch.Generator().manual_seed(9))
    for xx in (x, x[perm]):
        assert _b7_launch(xx, meta) == B.brick_atomic_groups(xx, meta) == \
            _brute_force(xx, meta, 32)


def test_c_meta_refuses_slots_past_int32():
    """B9 keys its atomics by slot = row·64 + vertex in int32, so the
    kernels' meta refuses tables of 2^25 rows or more."""
    ok = B.make_brick_meta([1000], ["Hash"], (1 << 25) - 1)
    assert B.c_meta(ok).lv[0].n_rows == (1 << 25) - 1
    big = B.make_brick_meta([1000], ["Hash"], 1 << 25)
    with pytest.raises(ValueError, match="int32"):
        B.c_meta(big)
