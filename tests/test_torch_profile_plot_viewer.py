"""The port's chunking, profiler, plots, data layers, viewer, the
repaired logger methods and `metrics.ssim`/`lpips`, against the JAX
package's.

* `scan_chunks`/`loop_chunks`: per-point outputs cut back to n0, sums
  into `sum_init`, padding with `pad_values`, against JAX's.
* The profiler tree (warm-up, frame count, depth, `then`, the report's
  lines) against JAX's on the same program of scopes; its nodes named in
  a `torch.profiler` trace (`device_trace`).
* Every plot function of `plot_basic`, `plot_2d` and `plot_3d` against
  JAX's: the colour maps bitwise in uint8 over a sweep with 0, 1, values
  outside [0, 1], ±inf and NaN; the matplotlib ones on the same figures.
* Every data layer, the PLY export, the projection and the overlay
  against JAX's, over the port's occupancy grid and forest space.
* `InteractiveViewer` on 127.0.0.1, port 0: the page, the layers and a
  frame fetched over loopback, then stopped; the frame the same bytes as
  `frame_png`, its pixels `img_to_uint8` of `NeuralRenderer`'s render
  (which the render tests hold against JAX's); the orbit camera, the
  buffer-to-frame mapping and the page against JAX's viewer.
* `Logger.add_figure`, `add_histogram` and `add_mesh` against JAX's
  (the image, the tensorboard call, the OBJ file); `ssim` within 1e-6 of
  JAX's; `lpips` raises ImportError in both without the package.
"""

import json
import os
import types
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nr3d_lib_tpu import plot as JP
from nr3d_lib_tpu_torch import plot as TP

torch.set_num_threads(1)


# -------------------------------------------------------------- chunking
@pytest.mark.parametrize("n0, max_chunk", [(37, 8), (32, 8), (5, 16)])
def test_chunks_match_jax(n0, max_chunk):
    from nr3d_lib_tpu.ops import chunking as JCH
    from nr3d_lib_tpu_torch.ops import chunking as TCH

    rng = np.random.default_rng(0)
    a = rng.normal(size=(n0, 3)).astype(np.float32)
    b = rng.integers(0, 9, (n0,)).astype(np.int32)
    init = rng.normal(size=(3,)).astype(np.float32)

    def body(x, i):
        return (x * 2.0 + 1.0, i + 1), (x.sum(0), )

    for jfn, tfn in ((JCH.scan_chunks, TCH.scan_chunks),
                     (JCH.loop_chunks, TCH.loop_chunks)):
        (jo, ji), (js,) = jfn(body, (jnp.asarray(a), jnp.asarray(b)), n0,
                              max_chunk, (jnp.asarray(init),), (0.5,))
        (to, ti), (ts,) = tfn(body, (torch.from_numpy(a),
                                     torch.from_numpy(b)), n0, max_chunk,
                              (torch.from_numpy(init),), (0.5,))
        assert to.shape == (n0, 3) and ti.dtype == torch.int32
        np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6,
                                   atol=1e-6)
    # the padding rows reach the body as pad_values
    seen = []
    TCH.loop_chunks(lambda x: (seen.append(x) or (x,), ()),
                    (torch.from_numpy(a),), n0, max_chunk, (), (0.5,))
    pad = len(seen) * max_chunk - n0
    if pad:
        assert torch.all(seen[-1][max_chunk - pad:] == 0.5)


# -------------------------------------------------------------- profiler
def _program(prof):
    fired = []
    prof.then = lambda p: fired.append(True)
    for _ in range(6):
        with prof.scope("step"):
            with prof.scope("render"):
                with prof.scope("march"):
                    with prof.scope("too_deep"):
                        pass
            with prof.scope("backward"):
                pass
            with prof.scope("render"):
                pass
        prof.step_frame()
    return fired


def test_profiler_tree_matches_jax(tmp_path, capsys):
    from nr3d_lib_tpu import profile as JPR
    from nr3d_lib_tpu_torch import profile as TPR

    jp = JPR.Profiler(warmup=2, record_frames=3, record_depth=3)
    tp = TPR.Profiler(warmup=2, record_frames=3, record_depth=3, sync=True)
    jf, tf = _program(jp), _program(tp)
    assert jf == tf == [True]

    def shape(node):
        return {k: (c.count, shape(c)) for k, c in node.children.items()}

    assert shape(tp.root) == shape(jp.root)
    step = tp.root.children["step"]
    assert step.count == 3 and step.children["render"].count == 6
    assert "too_deep" not in step.children["render"].children["march"] \
        .children
    for child in step.children.values():
        assert child.total <= step.total
    t_lines, j_lines = tp.report().splitlines(), jp.report().splitlines()
    assert t_lines[0] == j_lines[0]
    assert [l.split()[0] for l in t_lines] == [l.split()[0]
                                               for l in j_lines]
    # the decorator and context forms on the default profiler
    prof = TPR.enable_profiling()
    assert TPR.get_default_profiler() is prof

    @TPR.profile
    def f():
        with TPR.profile("inner"):
            return 1

    with TPR.profile("outer"):
        f()
        TPR.profile("deco")(f)()
    outer = prof.root.children["outer"]
    assert outer.count == 1 and set(outer.children) == {f.__qualname__,
                                                        "deco"}
    prof.reset()
    assert not prof.root.children
    # the node names reach a torch.profiler trace
    with TPR.device_trace(str(tmp_path / "trace")) as session:
        with prof.scope("traced_node"):
            torch.ones(8).sum()
    assert any(e.key == "traced_node" for e in session.key_averages())
    assert os.path.exists(tmp_path / "trace" / "trace.json")
    with TPR.debug_profile("dbg"):
        pass
    assert "[debug_profile] dbg:" in capsys.readouterr().out
    TPR._default = TPR.Profiler(enabled=False)


# ------------------------------------------------------------------ plots
SWEEP = np.asarray([0.0, 1.0, 0.5, -0.25, 1.5, np.inf, -np.inf, np.nan,
                    0.99609375, 0.00390625, 1.0 - 1e-7, 1e-9], np.float32)


def _sweep_image(rng) -> np.ndarray:
    vals = np.concatenate([SWEEP, rng.uniform(-0.2, 1.2, 244)
                           .astype(np.float32)])
    return vals.reshape(16, 16)


def test_color_maps_match_jax_bitwise():
    rng = np.random.default_rng(1)
    img = _sweep_image(rng)
    for scale in (None, 1.0, 0.5, 3.0):
        got = TP.color_depth(img, scale=scale)
        want = JP.color_depth(img, scale=scale)
        assert got.dtype == np.uint8 and np.array_equal(got, want), scale
        got = TP.color_error_map(img - 0.5, scale=scale)
        want = JP.color_error_map(img - 0.5, scale=scale)
        assert np.array_equal(got, want), scale
    t = torch.from_numpy(img)
    assert np.array_equal(TP.color_depth(t), JP.color_depth(img))
    for cmap in ("turbo", "coolwarm"):
        x = np.linspace(-0.1, 1.1, 100_001, dtype=np.float32)
        assert np.array_equal(TP.color_depth(x, 1.0, cmap),
                              JP.color_depth(x, 1.0, cmap))
    assert np.array_equal(TP.color_depth(img)[7 // 16, 7 % 16], [0, 0, 0])


def test_basic_plots_match_jax():
    rng = np.random.default_rng(2)
    img = rng.integers(0, 256, (20, 24, 3), np.uint8)
    mask = rng.uniform(size=(20, 24)) > 0.5
    n = rng.normal(size=(20, 24, 3)).astype(np.float32)
    for fn, args in ((lambda m, *a: m.overlay_mask(*a), (img, mask)),
                     (lambda m, *a: m.overlay_mask(*a, (0, 9, 200), 0.3),
                      (img.astype(np.float32) / 255, mask * 0.7)),
                     (lambda m, *a: m.colorize_normals(*a), (n,)),
                     (lambda m, *a: m.gallery(*a, ncols=2),
                      ([img, img[:10], img[:, :7]],))):
        np.testing.assert_array_equal(fn(TP, *args), fn(JP, *args))
    from nr3d_lib_tpu.plot import plot_basic as JB
    from nr3d_lib_tpu_torch.plot import plot_basic as TB

    np.testing.assert_array_equal(TB.draw_2dbox(img, (2, 3), (15, 18),
                                                (1, 2, 3), 2),
                                  JB.draw_2dbox(img, (2, 3), (15, 18),
                                                (1, 2, 3), 2))
    p0 = rng.uniform(-5, 30, (6, 2)).astype(np.float32)
    p1 = rng.uniform(-5, 30, (6, 2)).astype(np.float32)
    np.testing.assert_array_equal(TP.draw_segments_2d(img, p0, p1),
                                  JP.draw_segments_2d(img, p0, p1))

    def sdf(p):
        return np.linalg.norm(p, axis=-1) - 0.5

    for axis in (0, 2):
        np.testing.assert_array_equal(
            TP.sdf_slice_image(lambda p: torch.from_numpy(sdf(p)), axis,
                               0.1, 32),
            JP.sdf_slice_image(sdf, axis, 0.1, 32))


def test_figures_match_jax():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from nr3d_lib_tpu.plot import plot_3d as J3
    from nr3d_lib_tpu_torch.plot import plot_3d as T3

    def fig_line():
        fig, ax = plt.subplots(figsize=(2, 2), dpi=40)
        ax.plot([0, 1, 2], [2, 0, 1])
        return fig

    np.testing.assert_array_equal(TP.figure_to_image(fig_line()),
                                  JP.figure_to_image(fig_line()))
    occ = np.zeros((4, 4, 4), bool)
    occ[1, 2, 3] = occ[0, 0, 0] = True
    c2ws = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    c2ws[1, :3, 3] = (1, 0, 2)
    intr = np.asarray([[20, 0, 16], [0, 20, 12], [0, 0, 1]], np.float32)
    for t_fn, j_fn in (
            (lambda m: m.plot_camera_frusta(c2ws, intr, (24, 32)), None),
            (lambda m: m.plot_occ_grid(occ), None),
            (lambda m: m.plot_lineset(*m.trajectory_lines(
                np.arange(12.0).reshape(4, 3))), None)):
        imgs = []
        for mod in (T3, J3):
            ax = t_fn(mod)
            imgs.append(JP.figure_to_image(ax.figure))
        np.testing.assert_array_equal(imgs[0], imgs[1])


def test_plot_2d_matches_jax():
    from nr3d_lib_tpu.plot import plot_2d as J2
    from nr3d_lib_tpu_torch.plot import plot_2d as T2

    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (30, 40, 3), np.uint8)
    np.testing.assert_array_equal(T2.get_n_ind_colors(7),
                                  J2.get_n_ind_colors(7))
    for c in ((250, 250, 250), (5, 5, 5), (200, 30, 10)):
        assert T2.choose_contrast_color(c) == J2.choose_contrast_color(c)
    m = rng.uniform(size=(12, 9)) > 0.4
    ids = rng.integers(0, 5, (12, 9))
    patch = rng.integers(0, 256, (12, 9, 3), np.uint8)
    for h0, w0 in ((0, 0), (-4, 35), (25, -3), (50, 50)):
        np.testing.assert_array_equal(
            T2.draw_bool_mask(img, m, (1, 2, 3), 0.4, h0, w0),
            J2.draw_bool_mask(img, m, (1, 2, 3), 0.4, h0, w0))
        np.testing.assert_array_equal(T2.draw_int_mask(img, ids, None, 0.7,
                                                       h0, w0),
                                      J2.draw_int_mask(img, ids, None, 0.7,
                                                       h0, w0))
        np.testing.assert_array_equal(T2.draw_patch(img, patch, 0.5, h0, w0),
                                      J2.draw_patch(img, patch, 0.5, h0, w0))
    for label in (None, "car"):
        np.testing.assert_array_equal(
            T2.draw_2dbox_labeled(img, 20, 15, 16, 10, label=label,
                                  label2="0.9"),
            J2.draw_2dbox_labeled(img, 20, 15, 16, 10, label=label,
                                  label2="0.9"))


def test_plot_3d_lines_match_jax():
    from nr3d_lib_tpu.plot import plot_3d as J3
    from nr3d_lib_tpu_torch.plot import plot_3d as T3

    rng = np.random.default_rng(4)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 3] = (0.5, -1, 2)
    intr = np.asarray([[20, 0, 16], [0, 20, 12], [0, 0, 1]], np.float32)
    occ = rng.uniform(size=(5, 4, 3)) > 0.6
    mat = np.concatenate([np.eye(3), [[1], [2], [3]]], 1)
    pos = rng.normal(size=(7, 3))
    cases = [(lambda m: m.camera_frustum_lines(c2w, intr, (24, 32), 0.5),
              lambda m: m.camera_frustum_lines(torch.from_numpy(c2w),
                                               torch.from_numpy(intr),
                                               (24, 32), 0.5)),
             (lambda m: m.occgrid_box_lines(occ, (-1, -2, -3), (1, 2, 3)),
              lambda m: m.occgrid_box_lines(torch.from_numpy(occ),
                                            (-1, -2, -3), (1, 2, 3))),
             (lambda m: m.occgrid_box_lines(occ, max_boxes=5), None),
             (lambda m: m.obb_lines(mat, (1, 2, 3)), None),
             (lambda m: m.trajectory_lines(pos), None),
             (lambda m: m.merge_linesets([m.obb_lines(mat, (1, 1, 1)),
                                          m.trajectory_lines(pos)]), None)]
    for j_case, t_case in cases:
        want = j_case(J3)
        for got in (j_case(T3), (t_case or j_case)(T3)):
            for g, w in zip(got, want):
                assert g.dtype == w.dtype
                np.testing.assert_array_equal(g, w)


# ----------------------------------------------------------- data layers
def _forest_space():
    from nr3d_lib_tpu_torch.models.spatial.forest import ForestBlockSpace

    space = ForestBlockSpace(block_size=0.5, resolution=(3, 2, 2),
                             device="cpu")
    space.populate_from_corners([[0, 0, 0], [2, 1, 0], [1, 1, 1]])
    return space


def _as_jax_space(space):
    """The attributes JAX's layers read, as numpy (they index `[...]`)."""
    from nr3d_lib_tpu_torch.utils import to_numpy

    return types.SimpleNamespace(
        occupied=to_numpy(space.occupied), origin=to_numpy(space.origin),
        resolution=space.resolution, block_size=space.block_size,
        block_coords=to_numpy(space.block_coords))


def test_datalayers_match_jax(tmp_path):
    from nr3d_lib_tpu import gui_datalayers as JD
    from nr3d_lib_tpu_torch import gui_datalayers as TD
    from nr3d_lib_tpu_torch.models.accelerations import OccGridAccel
    from nr3d_lib_tpu_torch.models.spatial import AABBSpace

    rng = np.random.default_rng(5)
    accel = OccGridAccel(resolution=8, device="cpu")
    accel.occ.val_grid.copy_(torch.from_numpy(
        rng.uniform(size=(8, 8, 8)).astype(np.float32)))
    accel.space = AABBSpace(device="cpu")
    occ = accel.occ.occ().numpy()
    assert 0 < occ.sum() < occ.size
    j_accel = types.SimpleNamespace(
        occ=types.SimpleNamespace(occ=lambda: occ),
        space=types.SimpleNamespace(aabb=accel.space.aabb.numpy()))
    layers_t = [TD.occgrid_datalayer(accel)]
    layers_j = [JD.occgrid_datalayer(j_accel)]
    space = _forest_space()
    cells = rng.uniform(size=(space.block_coords.shape[0], 4, 4, 4)) > 0.8
    f_accel = types.SimpleNamespace(occ=types.SimpleNamespace(
        occ=lambda: torch.from_numpy(cells)))
    fj_accel = types.SimpleNamespace(occ=types.SimpleNamespace(
        occ=lambda: cells))
    layers_t += TD.forest_datalayer(space, f_accel)
    layers_j += JD.forest_datalayer(_as_jax_space(space), fj_accel)
    c2ws = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
    c2ws[:, :3, 3] = rng.normal(size=(3, 3))
    intr = np.asarray([[30, 0, 20], [0, 30, 15], [0, 0, 1]], np.float32)
    layers_t.append(TD.camera_datalayer(torch.from_numpy(c2ws), intr,
                                        (30, 40)))
    layers_j.append(JD.camera_datalayer(c2ws, intr, (30, 40)))
    aabb = np.asarray([[-1, -0.5, 0], [1, 0.5, 2]], np.float32)
    layers_t.append(TD.aabb_datalayer(torch.from_numpy(aabb)))
    layers_j.append(JD.aabb_datalayer(aabb))
    assert len(layers_t) == len(layers_j) == 5
    for lt, lj in zip(layers_t, layers_j):
        assert lt["name"] == lj["name"]
        for k in ("points", "edges", "color"):
            assert lt[k].dtype == lj[k].dtype, k
            np.testing.assert_array_equal(lt[k], lj[k])
    TD.save_linesets_ply(str(tmp_path / "t.ply"), layers_t)
    JD.save_linesets_ply(str(tmp_path / "j.ply"), layers_j)
    assert (tmp_path / "t.ply").read_text() == \
        (tmp_path / "j.ply").read_text()
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 3] = (0, 0, -4)
    for lt, lj in zip(layers_t, layers_j):
        for a, b in zip(TD.project_datalayer(lt, intr, c2w, (30, 40)),
                        JD.project_datalayer(lj, intr, c2w, (30, 40))):
            np.testing.assert_array_equal(a, b)
    frame = rng.integers(0, 256, (30, 40, 3), np.uint8)
    np.testing.assert_array_equal(TD.draw_datalayers(frame, layers_t, intr,
                                                     c2w),
                                  JD.draw_datalayers(frame, layers_j, intr,
                                                     c2w))


# ---------------------------------------------------------------- viewer
CFG = dict(field_cfg={"surface_cfg": {
    "encoding_cfg": {"lotd_cfg": {"lod_res": [8], "lod_n_feats": 2,
                                  "lod_types": "Dense"}},
    "decoder_cfg": {"D": 1, "W": 16}},
    "radiance_cfg": {"D": 1, "W": 16}},
    accel_cfg={"resolution": 8, "max_steps_per_ray": 32,
               "step_size": 2 / 16})


def test_viewer_serves_frames_over_loopback():
    from nr3d_lib_tpu import viewer as JV
    from nr3d_lib_tpu_torch import viewer as TV
    from nr3d_lib_tpu_torch.gui import NeuralRenderer
    from nr3d_lib_tpu_torch.models.model_base import LoTDNeuSModel
    from nr3d_lib_tpu_torch.utils import decode_png, img_to_uint8

    tm = LoTDNeuSModel(**CFG, device="cpu")
    tm.populate()
    v = TV.InteractiveViewer(tm, hw=(24, 24), host="127.0.0.1",
                             controls={"ts": {"min": -1, "max": 1}})
    url = v.start()
    try:
        page = urllib.request.urlopen(url + "/", timeout=120).read()
        assert b"nr3d_lib_tpu_torch viewer" in page
        layers = json.loads(urllib.request.urlopen(url + "/layers",
                                                   timeout=120).read())
        assert layers and layers[0].startswith("rgb")
        assert "ts" in json.loads(urllib.request.urlopen(
            url + "/controls", timeout=120).read())
        png = urllib.request.urlopen(
            url + "/render?theta=0.3&phi=0.2&radius=2.5&layer=" + layers[0],
            timeout=120).read()
        with pytest.raises(urllib.error.HTTPError, match="404"):
            urllib.request.urlopen(url + "/nothing", timeout=120)
    finally:
        v.stop()
    assert png == v.frame_png(0.3, 0.2, 2.5, layers[0])
    frame = decode_png(png)
    c2w = v.camera(0.3, 0.2, 2.5)
    want = img_to_uint8(NeuralRenderer(tm, (24, 24)).render(
        c2w, ray_extras={"ts": 0.0})["rgb_volume"])
    assert np.array_equal(frame, want) and frame.std() > 0
    depth = decode_png(v.frame_png(0.3, 0.2, 2.5, "depth_volume",
                                   overlay=True))
    assert depth.shape == (24, 24, 3)
    # JAX's orbit camera and buffer-to-frame mapping (its page as well)
    jv = JV.InteractiveViewer.__new__(JV.InteractiveViewer)
    jv._center = np.zeros(3, np.float32)
    np.testing.assert_allclose(c2w, jv._camera(0.3, 0.2, 2.5), rtol=0,
                               atol=1e-6)
    rng = np.random.default_rng(8)
    for shape in ((6, 5), (6, 5, 1), (6, 5, 3), (6, 5, 4)):
        buf = rng.uniform(-1.2, 1.5, shape).astype(np.float32)
        np.testing.assert_array_equal(TV._to_uint8_layer(buf),
                                      JV._to_uint8_layer(buf))
    assert TV._PAGE.replace("nr3d_lib_tpu_torch", "nr3d_lib_tpu") == \
        JV._PAGE


# ------------------------------------------------- logger and metrics
class _Board:
    """Stands in for a tensorboard writer; records its calls."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        return lambda *a, **k: self.calls.append((name, a, k))


def test_logger_figure_histogram_mesh_match_jax(tmp_path):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from nr3d_lib_tpu.logger import Logger as JL
    from nr3d_lib_tpu_torch.logger import Logger as TL
    from nr3d_lib_tpu_torch.utils import read_png

    rng = np.random.default_rng(6)
    verts = rng.normal(size=(5, 3)).astype(np.float32)
    faces = np.asarray([[0, 1, 2], [2, 3, 4]], np.int32)
    vals = rng.normal(size=100).astype(np.float32)
    files = {}
    for name, cls, conv in (("t", TL, torch.from_numpy), ("j", JL, np.asarray)):
        lg = cls(str(tmp_path / name), use_tensorboard=False)
        lg._tb = _Board()
        fig, ax = plt.subplots(figsize=(2, 2), dpi=30)
        ax.plot([0, 1], [1, 0])
        lg.add_figure("plots", "fig", fig, 3)
        lg.add_histogram("hist", "h", conv(vals), 4)
        lg.add_mesh("m", "mesh", conv(verts), conv(faces), 5)
        hist = [c for c in lg._tb.calls if c[0] == "add_histogram"]
        assert len(hist) == 1 and hist[0][1][0] == "hist/h"
        np.testing.assert_array_equal(hist[0][1][1], vals)
        lg._tb = None
        lg.close()
        files[name] = (read_png(str(tmp_path / name / "imgs" / "plots" /
                                    "fig_00000003.png")),
                       (tmp_path / name / "meshes" / "m" /
                        "mesh_00000005.obj").read_text())
    np.testing.assert_array_equal(files["t"][0], files["j"][0])
    assert files["t"][1] == files["j"][1]


def test_ssim_and_lpips_match_jax():
    from nr3d_lib_tpu.graphics import metrics as JM
    from nr3d_lib_tpu_torch.graphics import metrics as TM

    rng = np.random.default_rng(7)
    a = rng.uniform(size=(24, 20, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(size=a.shape).astype(np.float32) * 0.1, 0, 1)
    np.testing.assert_allclose(float(TM.ssim(torch.from_numpy(a),
                                             torch.from_numpy(b))),
                               float(JM.ssim(a, b)), rtol=1e-6, atol=1e-6)
    for mod, x in ((TM, torch.from_numpy(a)), (JM, a)):
        with pytest.raises(ImportError, match="lpips"):
            mod.lpips(x, x)
