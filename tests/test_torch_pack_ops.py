"""Port parity: every name of `graphics/pack_ops.py` and of
`graphics/raysample.py` against the JAX package on the CPU.

The packed buffers are ragged: seeded counts with empty packs, then
padding (ridx == n_packs) at the end. Every numpy input is float32 or
int32 (the conftest turns on x64 for JAX). Integers, booleans, indices and
sort orders must be equal; floats agree within 1e-6 absolute or 1e-5
relative (`_close`); gradients within 1e-5 relative L2. The sorts run on
keys with many ties, so their stability is held too. Where a function is
perturbed, JAX's uniforms are drawn from its key in its order and handed
to the port's `draw` or `u`.

Three findings in the reference (ROADMAP.md §C), each shown with JAX's
value beside the port's: the perturbed depth-step samplers return the
pre-jitter dt (the port re-differences the jittered t); `intersect1d_unique`
marks padding sentinels as in both lists (the port does not); the
packed-segments sampler's output is segment-major (both; documented).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nr3d_lib_tpu.graphics import nerf as jnerf
from nr3d_lib_tpu.graphics import pack_ops as J
from nr3d_lib_tpu.graphics import raysample as JR
from nr3d_lib_tpu_torch.graphics import nerf as tnerf
from nr3d_lib_tpu_torch.graphics import pack_ops as T
from nr3d_lib_tpu_torch.graphics import raysample as TR

COUNTS = np.asarray([3, 0, 5, 1, 0, 4, 2, 6, 0, 3], np.int32)
N_PACKS = COUNTS.shape[0]
CAP = int(COUNTS.sum()) + 5          # 5 padding slots at the end


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, atol=1e-6, rtol=1e-5):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


def _equal(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_array_equal(got, want)


def _ridx():
    return np.asarray(J.ridx_from_counts(jnp.asarray(COUNTS), CAP))


def _feats(shape=(), seed=0, lo=0.0, hi=1.0):
    rng = np.random.default_rng(seed)
    return rng.uniform(lo, hi, (CAP,) + shape).astype(np.float32)


def _ties(seed=0, levels=4):
    """float keys on a few values, so that sorts meet many ties."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, levels, CAP).astype(np.float32) * 0.25


# ============================================================ constructors
def test_pack_infos_and_ridx():
    c = jnp.asarray(COUNTS)
    ridx = _ridx()
    _equal(T.ridx_from_counts(_t(COUNTS), CAP), ridx)
    assert (ridx[-5:] == N_PACKS).all() and set(np.unique(ridx[:-5])) == \
        {i for i in range(N_PACKS) if COUNTS[i] > 0}
    _equal(T.ridx_from_counts(_t(COUNTS), CAP, N_PACKS + 2),
           J.ridx_from_counts(c, CAP, N_PACKS + 2))
    _equal(T.counts_from_ridx(_t(ridx), N_PACKS),
           J.counts_from_ridx(jnp.asarray(ridx), N_PACKS))
    _equal(T.offsets_from_counts(_t(COUNTS)), J.offsets_from_counts(c))
    _equal(T.get_pack_infos_from_n(_t(COUNTS)), J.get_pack_infos_from_n(c))
    first = np.asarray(J.offsets_from_counts(c), np.int32)
    _equal(T.get_pack_infos_from_first(_t(first), CAP),
           J.get_pack_infos_from_first(jnp.asarray(first), CAP))
    bound = np.asarray(J.mark_pack_boundaries(jnp.asarray(ridx)))
    _equal(T.mark_pack_boundaries(_t(ridx)), bound)
    _equal(T.get_pack_infos_from_boundary(_t(bound)),
           J.get_pack_infos_from_boundary(jnp.asarray(bound)))
    _equal(T.get_pack_infos_from_batch(4, 7, device="cpu"),
           J.get_pack_infos_from_batch(4, 7))
    _equal(T.expand_pack_boundary(_t(bound), 3),
           J.expand_pack_boundary(jnp.asarray(bound), 3))
    pidx = np.random.default_rng(1).integers(0, 3, CAP).astype(np.int32)
    _equal(T.octree_mark_consecutive_segments(_t(pidx), _t(ridx)),
           J.octree_mark_consecutive_segments(jnp.asarray(pidx),
                                              jnp.asarray(ridx)))


def test_interleave_constructors():
    c = jnp.asarray(COUNTS)
    for got, want in zip(T.interleave_arange_simple(_t(COUNTS), CAP),
                         J.interleave_arange_simple(c, CAP)):
        _equal(got, want)
    rng = np.random.default_rng(2)
    start = rng.uniform(0, 2, N_PACKS).astype(np.float32)
    step = rng.uniform(0.1, 0.5, N_PACKS).astype(np.float32)
    stop = (start + step * COUNTS).astype(np.float32)
    cases = [
        (T.interleave_linstep(_t(start), _t(COUNTS), _t(step), CAP),
         J.interleave_linstep(jnp.asarray(start), c, jnp.asarray(step), CAP)),
        (T.interleave_arange(_t(start), _t(stop), 0.3, CAP),
         J.interleave_arange(jnp.asarray(start), jnp.asarray(stop),
                             np.float32(0.3), CAP)),
        (T.interleave_arange(_t(start), _t(stop), _t(step), CAP),
         J.interleave_arange(jnp.asarray(start), jnp.asarray(stop),
                             jnp.asarray(step), CAP)),
        (T.interleave_linspace(_t(start), _t(stop), 4, CAP),
         J.interleave_linspace(jnp.asarray(start), jnp.asarray(stop), 4,
                               CAP)),
        (T.interleave_linspace(_t(start), _t(stop), _t(COUNTS), CAP),
         J.interleave_linspace(jnp.asarray(start), jnp.asarray(stop), c,
                               CAP))]
    for (tv, tr), (jv, jr) in cases:
        _equal(tr, jr)
        _close(tv, jv)


# ==================================================== broadcast arithmetic
BINOPS = ["packed_add", "packed_sub", "packed_mul", "packed_div",
          "packed_gt", "packed_geq", "packed_lt", "packed_leq", "packed_eq",
          "packed_neq"]


@pytest.mark.parametrize("name", BINOPS)
def test_packed_binops(name):
    ridx = _ridx()
    rng = np.random.default_rng(3)
    pv = rng.integers(-2, 3, N_PACKS).astype(np.float32) * 0.25
    pv[4] = 0.0                                # packed_div's 0 → ÷ 1
    for feats in (_ties(4), _ties(5)[:, None].repeat(3, 1)):
        got = getattr(T, name)(_t(feats), _t(pv), _t(ridx))
        want = getattr(J, name)(jnp.asarray(feats), jnp.asarray(pv),
                                jnp.asarray(ridx))
        if got.dtype == torch.bool:
            _equal(got, want)
        else:
            _close(got, want)
    # a matrix of per-pack values against matrix features
    pv2 = rng.uniform(-1, 1, (N_PACKS, 3)).astype(np.float32)
    f2 = _feats((3,), 6)
    got = getattr(T, name)(_t(f2), _t(pv2), _t(ridx), N_PACKS)
    want = getattr(J, name)(jnp.asarray(f2), jnp.asarray(pv2),
                            jnp.asarray(ridx), N_PACKS)
    (_equal if got.dtype == torch.bool else _close)(got, want)


# ================================================================ reductions
@pytest.mark.parametrize("name", ["packed_sum", "packed_mean", "packed_max",
                                  "packed_min"])
@pytest.mark.parametrize("kind", ["f32", "f32x3", "i32"])
def test_packed_reductions(name, kind):
    """Empty packs included: max/min give the dtype's lowest/highest,
    the mean 0; the padding's values (set huge) are dropped."""
    ridx = _ridx()
    if kind == "i32":
        feats = np.random.default_rng(7).integers(-50, 50, CAP).astype(
            np.int32)
        feats[-5:] = 10 ** 6
    else:
        feats = _feats((3,) if kind == "f32x3" else (), 7, -1, 1)
        feats[-5:] = 1e6
    got = getattr(T, name)(_t(feats), _t(ridx), N_PACKS)
    want = getattr(J, name)(jnp.asarray(feats), jnp.asarray(ridx), N_PACKS)
    if kind == "i32" and name != "packed_mean":
        assert got.dtype == torch.int32
        _equal(got, want)
    else:
        _close(got, want)
    if name in ("packed_max", "packed_min"):
        lowest = name == "packed_max"
        edge = (-np.inf if lowest else np.inf) if kind != "i32" else \
            (np.iinfo(np.int32).min if lowest else np.iinfo(np.int32).max)
        assert (got.numpy()[COUNTS == 0] == edge).all()


# ======================================================== cumulative / diff
# JAX's scans under jit: eager, `associative_scan` dispatches hundreds of
# small ops (the values are the same)
_J_CUMSUM = jax.jit(J.packed_cumsum, static_argnums=2)
_J_CUMPROD = jax.jit(J.packed_cumprod, static_argnums=2)
_J_SCAN = jax.jit(J.segmented_scan, static_argnames=("op", "reverse"))


def test_packed_scans():
    ridx = _ridx()
    rid = jnp.asarray(ridx)
    for feats in (_feats((), 8), _feats((2,), 9)):
        f = jnp.asarray(feats)
        for exclusive in (False, True):
            _close(T.packed_cumsum(_t(feats), _t(ridx), exclusive),
                   _J_CUMSUM(f, rid, exclusive))
            _close(T.packed_cumprod(_t(feats), _t(ridx), exclusive),
                   _J_CUMPROD(f, rid, exclusive))
        start = np.asarray(J.mark_pack_boundaries(rid))
        for reverse in (False, True):
            _close(T.segmented_scan(_t(feats), _t(start), reverse=reverse),
                   _J_SCAN(f, jnp.asarray(start), reverse=reverse))
        _close(T.segmented_scan(_t(feats), _t(start), op=torch.maximum),
               _J_SCAN(f, jnp.asarray(start), op=jnp.maximum))
    ints = np.random.default_rng(10).integers(0, 9, CAP).astype(np.int32)
    _equal(T.packed_cumsum(_t(ints), _t(ridx)),
           _J_CUMSUM(jnp.asarray(ints), rid, False))


def test_packed_diffs():
    ridx = _ridx()
    rid = jnp.asarray(ridx)
    fill = np.random.default_rng(11).uniform(2, 3, N_PACKS).astype(np.float32)
    for feats in (_feats((), 12), _feats((3,), 13)):
        f = jnp.asarray(feats)
        _close(T.packed_diff(_t(feats), _t(ridx)), J.packed_diff(f, rid))
        _close(T.packed_diff(_t(feats), _t(ridx), pad_value=-1.0),
               J.packed_diff(f, rid, pad_value=-1.0))
        _close(T.packed_backward_diff(_t(feats), _t(ridx), pad_value=0.5),
               J.packed_backward_diff(f, rid, pad_value=0.5))
        if feats.ndim == 1:
            _close(T.packed_diff(_t(feats), _t(ridx), pack_last_fill=_t(fill)),
                   J.packed_diff(f, rid, pack_last_fill=jnp.asarray(fill)))
            _close(T.packed_backward_diff(_t(feats), _t(ridx),
                                          pack_first_fill=_t(fill)),
                   J.packed_backward_diff(f, rid,
                                          pack_first_fill=jnp.asarray(fill)))


def test_packed_scans_gradients():
    """cumsum, tau_to_vw and alpha_to_vw against `jax.grad`."""
    ridx = _ridx()
    rid = jnp.asarray(ridx)
    feats = _feats((), 14, 0.0, 0.9)
    w = _feats((), 15, -1, 1)
    for jf, tf in ((lambda x: J.packed_cumsum(x, rid, True),
                    lambda x: T.packed_cumsum(x, _t(ridx), True)),
                   (lambda x: J.packed_tau_to_vw(x, rid),
                    lambda x: T.packed_tau_to_vw(x, _t(ridx))),
                   (lambda x: J.packed_alpha_to_vw(x, rid),
                    lambda x: T.packed_alpha_to_vw(x, _t(ridx)))):
        gj = np.asarray(jax.jit(jax.grad(lambda x: jnp.sum(jf(x) * w)))(
            jnp.asarray(feats)))
        x = _t(feats).requires_grad_(True)
        torch.sum(tf(x) * _t(w)).backward()
        assert np.linalg.norm(x.grad.numpy() - gj) <= \
            1e-5 * np.linalg.norm(gj)


# ============================================================ sort / search
@pytest.mark.parametrize("name", ["packed_sort", "packed_sort_inplace"])
def test_packed_sort_is_stable(name):
    """Keys on four values (ties in every pack): the payload's order
    within equal keys is kept, as `lax.sort(is_stable=True)`."""
    ridx = _ridx()
    # shuffle the packs' samples so that ridx is not sorted either
    perm = np.random.default_rng(16).permutation(CAP)
    r, key = ridx[perm], _ties(17)
    pay = np.arange(CAP, dtype=np.int32)
    pay2 = _feats((), 18)
    got = getattr(T, name)(_t(key), _t(r), _t(pay), _t(pay2))
    want = getattr(J, name)(jnp.asarray(key), jnp.asarray(r),
                            jnp.asarray(pay), jnp.asarray(pay2))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        _equal(g, w)


def _sorted_bins(seed):
    """Packed sorted bins with ties, padding at the end."""
    ridx = _ridx()
    key, r = J.packed_sort(jnp.asarray(_ties(seed)), jnp.asarray(ridx))
    return np.asarray(key), np.asarray(r)


@pytest.mark.parametrize("side", ["right", "left"])
@pytest.mark.parametrize("name", ["packed_searchsorted",
                                  "packed_searchsorted_packed_vals"])
def test_packed_searchsorted(side, name):
    """Values on the bins' own edges (ties at a bin edge) and between
    them, in packs with and without bins."""
    bins, bridx = _sorted_bins(19)
    rng = np.random.default_rng(20)
    nv = 40
    vals = (rng.integers(0, 9, nv) * 0.125).astype(np.float32)
    vridx = rng.integers(0, N_PACKS + 1, nv).astype(np.int32)
    got = getattr(T, name)(_t(bins), _t(bridx), _t(vals), _t(vridx),
                           N_PACKS, side=side)
    want = getattr(J, name)(jnp.asarray(bins), jnp.asarray(bridx),
                            jnp.asarray(vals), jnp.asarray(vridx), N_PACKS,
                            side=side)
    _equal(got, want)
    assert got.dtype == torch.int32


def _cdf_pack(seed):
    """Packed (bins, cdfs): each pack's bins ascending, its CDF rising
    from 0 to 1 with a flat step (a zero-weight bin)."""
    ridx = _ridx()
    rng = np.random.default_rng(seed)
    bins = np.zeros(CAP, np.float32)
    cdfs = np.zeros(CAP, np.float32)
    o = 0
    for c in COUNTS:
        if c:
            bins[o:o + c] = np.sort(rng.uniform(0, 4, c))
            w = rng.uniform(0, 1, c)
            w[min(1, c - 1)] = 0.0
            cw = np.cumsum(w)
            cdfs[o:o + c] = cw / max(cw[-1], 1e-6)
            cdfs[o] = 0.0
        o += c
    return bins, cdfs, ridx


def test_packed_invert_cdf_and_sample_cdf():
    bins, cdfs, ridx = _cdf_pack(21)
    rng = np.random.default_rng(22)
    nu = 30
    u = rng.uniform(0, 1, nu).astype(np.float32)
    u[:4] = cdfs[[3, 4, 9, 10]]               # on the CDF's own values
    ur = np.sort(rng.choice(np.nonzero(COUNTS)[0], nu)).astype(np.int32)
    _close(T.packed_invert_cdf(_t(bins), _t(cdfs), _t(ridx), _t(u), _t(ur),
                               N_PACKS),
           J.packed_invert_cdf(jnp.asarray(bins), jnp.asarray(cdfs),
                               jnp.asarray(ridx), jnp.asarray(u),
                               jnp.asarray(ur), N_PACKS))
    jb, jc, jr = (jnp.asarray(a) for a in (bins, cdfs, ridx))
    for key in (None, jax.random.key(3)):
        t_j, r_j = JR.packed_sample_cdf(jb, jc, jr, N_PACKS, 5,
                                        perturb_key=key)
        u = None if key is None else _t(np.asarray(jax.random.uniform(
            key, (N_PACKS * 5,), jnp.float32, minval=1e-8,
            maxval=1.0 - 1e-8)))
        t_t, r_t = TR.packed_sample_cdf(_t(bins), _t(cdfs), _t(ridx),
                                        N_PACKS, 5, u=u)
        _equal(r_t, r_j)
        _close(t_t, t_j)


# =========================================================== volume render
def test_volume_render():
    ridx = _ridx()
    rid = jnp.asarray(ridx)
    alpha = _feats((), 23, 0.0, 0.9)
    alpha[[0, 7]] = 1.0                        # opaque samples
    tau = _feats((), 24, 0.0, 3.0)
    _close(T.packed_alpha_to_vw(_t(alpha), _t(ridx)),
           J.packed_alpha_to_vw(jnp.asarray(alpha), rid))
    _close(T.packed_tau_to_vw(_t(tau), _t(ridx)),
           J.packed_tau_to_vw(jnp.asarray(tau), rid))
    _close(tnerf.packed_tau_to_vw(_t(tau), _t(ridx)),
           jnerf.packed_tau_to_vw(jnp.asarray(tau), rid))
    for eps in (1e-4, 0.05):
        keep, vw = T.packed_volume_render_compression(_t(alpha), _t(ridx),
                                                      N_PACKS, eps)
        kj, vj = J.packed_volume_render_compression(jnp.asarray(alpha), rid,
                                                    N_PACKS, eps)
        _equal(keep, kj)
        _close(vw, vj)
    assert not keep.all() and keep.any()


# ================================================================ structural
def test_compaction_and_dense():
    ridx = _ridx()
    rid = jnp.asarray(ridx)
    feats = _feats((2,), 25)
    keep = np.random.default_rng(26).uniform(size=CAP) < 0.6
    (got,), gr = T.compactify(_t(keep), [_t(feats)], _t(ridx), N_PACKS, 20)
    (want,), wr = J.compactify(jnp.asarray(keep), [jnp.asarray(feats)], rid,
                               N_PACKS, 20)
    _equal(gr, wr)
    _equal(got, want)
    for m in (3, 6):
        for g, w in zip(T.packed_to_dense(_t(feats), _t(ridx), N_PACKS, m,
                                          -1.0),
                        J.packed_to_dense(jnp.asarray(feats), rid, N_PACKS,
                                          m, -1.0)):
            _equal(g, w)
    dense = np.random.default_rng(27).uniform(size=(5, 6, 2)).astype(
        np.float32)
    mask = np.random.default_rng(28).uniform(size=(5, 6)) < 0.5
    for g, w in zip(T.dense_to_packed(_t(dense), _t(mask), 25),
                    J.dense_to_packed(jnp.asarray(dense), jnp.asarray(mask),
                                      25)):
        _equal(g, w)
    for g, w in zip(T.budget_indices(_t(mask), 3),
                    J.budget_indices(jnp.asarray(mask), 3)):
        _equal(g, w)
    ints = np.random.default_rng(29).integers(-2 ** 30, 2 ** 30, (5, 6)
                                              ).astype(np.int32)
    (gd, gi), gv = T.dense_to_budgeted([_t(dense), _t(ints)], _t(mask), 3)
    (jd, ji), jv = J.dense_to_budgeted([jnp.asarray(dense),
                                        jnp.asarray(ints)],
                                       jnp.asarray(mask), 3)
    _equal(gv, jv)
    _equal(gd, jd)
    _equal(gi, ji)


@pytest.mark.parametrize("name", ["merge_two_packs_sorted_aligned",
                                  "try_merge_two_packs_sorted_aligned",
                                  "merge_two_packs_sorted",
                                  "merge_two_packs_sorted_a_includes_b"])
def test_merge_two_packs(name):
    """Keys that tie across A and B: A's sample comes first."""
    ka, ra = _sorted_bins(30)
    kb, rb = _sorted_bins(31)
    rb = np.where(rb == 2, N_PACKS, rb).astype(np.int32)   # b lacks pack 2
    kb, rb = (np.asarray(a) for a in J.packed_sort(jnp.asarray(kb),
                                                   jnp.asarray(rb)))
    for va, vb in ((_feats((), 32), _feats((), 33)),
                   (_feats((3,), 34), _feats((3,), 35))):
        got = getattr(T, name)(_t(va), _t(ka), _t(ra), _t(vb), _t(kb),
                               _t(rb), N_PACKS)
        want = getattr(J, name)(*(jnp.asarray(a) for a in
                                  (va, ka, ra, vb, kb, rb)), N_PACKS)
        for g, w in zip(got, want):
            _equal(g, w)


def test_merge_two_batch_and_matmul():
    rng = np.random.default_rng(36)
    ka = np.sort((rng.integers(0, 6, (4, 5)) * 0.5).astype(np.float32), -1)
    kb = np.sort((rng.integers(0, 6, (4, 3)) * 0.5).astype(np.float32), -1)
    for va, vb in ((ka + 10, kb + 20),
                   (rng.uniform(size=(4, 5, 2)).astype(np.float32),
                    rng.uniform(size=(4, 3, 2)).astype(np.float32))):
        got = T.merge_two_batch(_t(va), _t(ka), _t(vb), _t(kb))
        want = J.merge_two_batch(*(jnp.asarray(a) for a in (va, ka, vb, kb)))
        for g, w in zip(got, want):
            _equal(g, w)
    va = np.sort(rng.uniform(size=(5, 4)).astype(np.float32), -1)
    vb = np.sort(rng.uniform(size=(2, 3)).astype(np.float32), -1)
    na = np.asarray([0, 1, 3, 4, 6], np.int32)
    nb = np.asarray([1, 4], np.int32)
    got = T.merge_two_batch_a_includes_b(_t(va), _t(na), _t(vb), _t(nb), 6)
    want = J.merge_two_batch_a_includes_b(*(jnp.asarray(a) for a in
                                            (va, na, vb, nb)), 6)
    for g, w in zip(got, want):
        _equal(g, w)
    ridx = _ridx()
    mats = rng.uniform(-1, 1, (N_PACKS, 2, 3)).astype(np.float32)
    feats = _feats((3,), 37)
    _close(T.packed_matmul(_t(feats), _t(mats), _t(ridx)),
           J.packed_matmul(jnp.asarray(feats), jnp.asarray(mats),
                           jnp.asarray(ridx)))


# ======================================================= depth-step samplers
def _rays_near_far(n=6):
    rng = np.random.default_rng(38)
    near = rng.uniform(0.2, 1.0, n).astype(np.float32)
    far = (near + rng.uniform(0.5, 3.0, n)).astype(np.float32)
    return near, far


def test_depth_clamped_sampler_unperturbed():
    near, far = _rays_near_far()
    kw = dict(max_steps=40, dt_gamma=0.05, min_step_size=0.02,
              max_step_size=0.2, step_size_factor=1.5)
    got = T.interleave_sample_step_wrt_depth_clamped(_t(near), _t(far), **kw)
    want = J.interleave_sample_step_wrt_depth_clamped(
        jnp.asarray(near), jnp.asarray(far), **kw)
    _equal(got[2], want[2])
    _close(got[0], want[0])
    _close(got[1], want[1])


def test_depth_clamped_sampler_perturbed_finding():
    """ROADMAP.md §C (pack_ops.py:681): JAX returns the pre-jitter dt, so
    t_k + dt_k ≠ t_{k+1} and the intervals overlap or leave gaps. The port
    takes the same t (JAX's uniforms replayed) and re-differences them:
    its intervals partition each ray, the last sample keeping its step."""
    near, far = _rays_near_far()
    kw = dict(max_steps=40, dt_gamma=0.05, min_step_size=0.02,
              max_step_size=0.2)
    key = jax.random.key(4)
    tj, dtj, rj = (np.asarray(a) for a in
                   J.interleave_sample_step_wrt_depth_clamped(
                       jnp.asarray(near), jnp.asarray(far), **kw,
                       perturb_key=key))
    u = np.asarray(jax.random.uniform(key, (6, 40), jnp.float32))

    def draw(shape, lo, hi):
        assert tuple(shape) == u.shape and (lo, hi) == (0.0, 1.0)
        return _t(u)

    tt, dtt, rt = T.interleave_sample_step_wrt_depth_clamped(
        _t(near), _t(far), **kw, draw=draw)
    _equal(rt, rj)
    _close(tt, tj)
    t2, d2j, d2t, r2 = (a.reshape(6, 40) for a in
                        (tt.numpy(), dtj, dtt.numpy(), rt.numpy()))
    live = r2 < 6
    inner = live[:, :-1] & live[:, 1:]
    gap_j = np.abs(t2[:, :-1] + d2j[:, :-1] - t2[:, 1:])[inner]
    gap_t = np.abs(t2[:, :-1] + d2t[:, :-1] - t2[:, 1:])[inner]
    print(f"JAX: max |t_k + dt_k - t_(k+1)| {gap_j.max():.3e}; port "
          f"{gap_t.max():.3e}")
    assert gap_j.max() > 1e-3 and gap_t.max() <= 1e-6
    last = live & ~np.concatenate([live[:, 1:], np.zeros((6, 1), bool)], 1)
    _close(d2t[last], d2j[last])          # the last interval keeps its step


def test_packed_segments_sampler_and_finding():
    """Unperturbed: JAX's output exactly. The layout is segment-major (a
    ray with two segments has two runs; padding between them) in both
    packages: ROADMAP.md §C (pack_ops.py:688), the port documents it.
    Perturbed: the port re-differences within each segment."""
    near, far = _rays_near_far(4)
    entry = np.asarray([0.3, 1.9, 0.5, 0.0, 1.0], np.float32)
    exit_ = np.asarray([1.5, 2.6, 2.2, 0.0, 3.0], np.float32)
    seg_ridx = np.asarray([0, 0, 2, 4, 3], np.int32)     # seg 3: padding
    kw = dict(steps_per_segment=12, dt_gamma=0.1, min_step_size=0.05,
              max_step_size=0.3)
    args_t = [_t(a) for a in (near, far, entry, exit_, seg_ridx)]
    args_j = [jnp.asarray(a) for a in (near, far, entry, exit_, seg_ridx)]
    got = T.interleave_sample_step_wrt_depth_in_packed_segments(
        *args_t, 4, **kw)
    want = J.interleave_sample_step_wrt_depth_in_packed_segments(
        *args_j, 4, **kw)
    for g, w, exact in zip(got, want, (False, False, True, True)):
        (_equal if exact else _close)(g, w)
    r = got[2].numpy()
    runs = np.nonzero(np.diff(r) != 0)[0]
    assert (r[runs] == 0).sum() >= 2 and (r[:-1] == 4).any(), \
        "expected ray 0 in two runs and padding mid-buffer"
    key = jax.random.key(5)
    want = [np.asarray(a) for a in
            J.interleave_sample_step_wrt_depth_in_packed_segments(
                *args_j, 4, **kw, perturb_key=key)]
    u = np.asarray(jax.random.uniform(key, (5, 12), jnp.float32))
    got = T.interleave_sample_step_wrt_depth_in_packed_segments(
        *args_t, 4, **kw, draw=lambda shape, lo, hi: _t(u))
    _equal(got[2], want[2])
    _equal(got[3], want[3])
    _close(got[0], want[0])
    t2, dj, dt2, s2 = (a.reshape(5, 12) for a in
                       (got[0].numpy(), want[1], got[1].numpy(),
                        got[3].numpy()))
    inner = (s2[:, :-1] < 5) & (s2[:, 1:] < 5)
    gap_j = np.abs(t2[:, :-1] + dj[:, :-1] - t2[:, 1:])[inner].max()
    gap_t = np.abs(t2[:, :-1] + dt2[:, :-1] - t2[:, 1:])[inner].max()
    print(f"JAX: max gap {gap_j:.3e}; port {gap_t:.3e}")
    assert gap_j > 1e-3 and gap_t <= 1e-6


@pytest.mark.parametrize("dtype", ["int32", "float32"])
def test_intersect1d_unique_finding(dtype):
    """ROADMAP.md §C (pack_ops.py:794): with both lists sentinel-padded,
    JAX's masks are True on the padding; the port's are False there and
    equal JAX's elsewhere; the unions are equal."""
    sent = np.iinfo(np.int32).max if dtype == "int32" else np.inf
    a = np.asarray([1, 3, 4, 7, sent, sent], dtype)
    b = np.asarray([0, 3, 7, 9, 11, sent, sent, sent], dtype)
    ia, ib, un = (np.asarray(x) for x in
                  J.intersect1d_unique(jnp.asarray(a), jnp.asarray(b), 10))
    ta, tb, tu = T.intersect1d_unique(_t(a), _t(b), 10)
    print(f"JAX in_both_a {ia.tolist()}; port {ta.tolist()}")
    assert ia[a == sent].all() and ib[b == sent].all()        # JAX's fault
    assert not ta[_t(a == sent)].any() and not tb[_t(b == sent)].any()
    _equal(ta.numpy()[a != sent], ia[a != sent])
    _equal(tb.numpy()[b != sent], ib[b != sent])
    _equal(tu, un)


# ============================================================== raysample
@pytest.mark.parametrize("name", ["batch_sample_step_wrt_depth",
                                  "batch_sample_step_wrt_sqrt_depth"])
@pytest.mark.parametrize("perturb", [False, True])
def test_depth_step_samplers(name, perturb):
    near, far = _rays_near_far(8)
    near[0] = 0.0                            # the clamp at 1e-6
    key = jax.random.key(6) if perturb else None
    tj, dtj = getattr(JR, name)(jnp.asarray(near), jnp.asarray(far), 16,
                                perturb_key=key)
    u = None if key is None else _t(np.asarray(jax.random.uniform(
        key, (8, 16), jnp.float32)))
    tt, dtt = getattr(TR, name)(_t(near), _t(far), 16, u=u)
    _close(tt, tj)
    _close(dtt, dtj)
