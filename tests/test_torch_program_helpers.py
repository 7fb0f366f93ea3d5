"""Port parity: the program layer's helpers against the JAX package on
the CPU (inputs pinned to float32: the conftest turns on x64).

* cameras (`pixel_grid`, `pinhole_lift`, `pinhole_get_rays`, `look_at`,
  `spherical_camera_path`), `psnr` with and without a mask, and the sRGB
  pair: within 1e-6;
* `knn_points`, `knn_gather` and `chamfer_distance` (squared and not) on
  clouds with distinct distances: indices exact, distances within 1e-6;
* `save_obj` and `save_ply` files byte for byte JAX's on the same arrays,
  and the loaders' round trips;
* the port's standard-library PNG, decoded with PIL, pixel for pixel
  JAX's `save_image`; `gallery` equal to JAX's; `Logger`'s
  `scalars.jsonl` line for line JAX's for the same calls;
* `marching_cubes` (the port's own build of the native marching
  tetrahedra) equal to JAX's native path on a sphere, a box and an empty
  volume; `_surface_nets` equal to JAX's;
* `sorted_ckpts` in JAX's order; `CheckpointIO`'s filters, its
  `before_load_state_dict` hook and `load_latest`.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import nr3d_lib_tpu.graphics.cameras as JC
import nr3d_lib_tpu.graphics.metrics as JMET
import nr3d_lib_tpu.graphics.pointcloud as JPC
import nr3d_lib_tpu.graphics.trianglemesh as JTM
import nr3d_lib_tpu.maths.knn as JK
import nr3d_lib_tpu.plot.plot_basic as JPB
import nr3d_lib_tpu.utils as JU
from nr3d_lib_tpu.checkpoint import sorted_ckpts as j_sorted
from nr3d_lib_tpu.logger import Logger as JLogger
from nr3d_lib_tpu_torch.checkpoint import CheckpointIO, sorted_ckpts
from nr3d_lib_tpu_torch.graphics import cameras as TC
from nr3d_lib_tpu_torch.graphics import metrics as TMET
from nr3d_lib_tpu_torch.graphics import pointcloud as TPC
from nr3d_lib_tpu_torch.graphics import trianglemesh as TTM
from nr3d_lib_tpu_torch.logger import Logger as TLogger
from nr3d_lib_tpu_torch.maths import knn as TK
from nr3d_lib_tpu_torch.plot import gallery
from nr3d_lib_tpu_torch.utils import img_to_uint8, save_image

CPU = "cpu"


def _close(a, b, tol=1e-6):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), rtol=0, atol=tol)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


# ---------------------------------------------------------------- cameras
def test_pixel_grid_and_lift_match_jax():
    _close(TC.pixel_grid(5, 7, device=CPU), JC.pixel_grid(5, 7))
    rng = np.random.default_rng(0)
    uv = rng.uniform(0, 64, (50, 2)).astype(np.float32)
    intr = np.asarray([[70.0, 0.3, 31.0], [0, 66.0, 29.0], [0, 0, 1]],
                      np.float32)
    depth = rng.uniform(0.5, 3, 50).astype(np.float32)
    _close(TC.pinhole_lift(_t(uv), _t(intr)),
           JC.pinhole_lift(jnp.asarray(uv), jnp.asarray(intr)))
    _close(TC.pinhole_lift(_t(uv), _t(intr), _t(depth)),
           JC.pinhole_lift(jnp.asarray(uv), jnp.asarray(intr),
                           jnp.asarray(depth)), 1e-5)


@pytest.mark.parametrize("normalize", [True, False])
def test_look_at_and_rays_match_jax(normalize):
    eye, tgt = (1.4, 1.0, 1.4), (0.0, -0.1, 0.0)
    c2w_t = TC.look_at(eye, tgt, device=CPU)
    c2w_j = JC.look_at(eye, tgt)
    _close(c2w_t, c2w_j)
    uv = TC.pixel_grid(24, 24, device=CPU).reshape(-1, 2)
    intr = np.asarray([[21.6, 0, 12], [0, 21.6, 12], [0, 0, 1]], np.float32)
    o_t, d_t = TC.pinhole_get_rays(uv, _t(intr), c2w_t, normalize)
    o_j, d_j = JC.pinhole_get_rays(jnp.asarray(uv.numpy()),
                                   jnp.asarray(intr), c2w_j, normalize)
    _close(o_t, o_j)
    _close(d_t, d_j)
    # a tensor eye keeps its device, and up may be given
    m = TC.look_at(torch.tensor([0.5, 2.0, 0.1]), [0.0, 0.0, 0.0],
                   up=(0.0, 0.0, 1.0))
    _close(m, JC.look_at([0.5, 2.0, 0.1], [0.0, 0.0, 0.0],
                         up=(0.0, 0.0, 1.0)))


def test_spherical_camera_path_matches_jax():
    _close(TC.spherical_camera_path(8, 2.5, 0.4, device=CPU),
           JC.spherical_camera_path(8, 2.5, 0.4), 1e-6)
    _close(TC.spherical_camera_path(5, 3.0, 0.3, center=(0.1, 0.0, -0.2),
                                    device=CPU),
           JC.spherical_camera_path(5, 3.0, 0.3, center=(0.1, 0.0, -0.2)),
           1e-6)


# ---------------------------------------------------------------- metrics
def test_psnr_matches_jax():
    rng = np.random.default_rng(1)
    a = rng.uniform(size=(32, 24, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.05, a.shape), 0, 1).astype(np.float32)
    mask = rng.uniform(size=(32, 24)) < 0.6
    _close(TMET.psnr(_t(a), _t(b)), JMET.psnr(a, b), 1e-5)
    _close(TMET.psnr(_t(a), _t(b), mask=torch.from_numpy(mask)),
           JMET.psnr(a, b, mask=jnp.asarray(mask)), 1e-5)
    _close(TMET.psnr(_t(a), _t(b), max_val=2.0),
           JMET.psnr(a, b, max_val=2.0), 1e-5)
    assert float(TMET.psnr(_t(a), _t(a))) == pytest.approx(120.0)


def test_srgb_pair_matches_jax():
    x = np.linspace(-0.1, 1.1, 1001).astype(np.float32)
    _close(TMET.linear_to_srgb(_t(x)), JMET.linear_to_srgb(jnp.asarray(x)))
    _close(TMET.srgb_to_linear(_t(x)), JMET.srgb_to_linear(jnp.asarray(x)))


# -------------------------------------------------------------------- knn
def _clouds(n, m, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 3)).astype(np.float32) + 5.0,
            rng.normal(size=(m, 3)).astype(np.float32) + 5.0)


@pytest.mark.parametrize("k,chunk", [(1, 8192), (4, 64)])
def test_knn_points_and_gather_match_jax(k, chunk):
    x, y = _clouds(300, 500, 2)
    d_t, i_t = TK.knn_points(_t(x), _t(y), k, chunk=chunk)
    d_j, i_j = JK.knn_points(jnp.asarray(x), jnp.asarray(y), k, chunk=chunk)
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    _close(d_t, d_j)
    _close(TK.knn_gather(_t(y), i_t), JK.knn_gather(jnp.asarray(y), i_j))
    # batched
    xb, yb = np.stack([x, x[::-1]]), np.stack([y, y[::-1]])
    d_t, i_t = TK.knn_points(_t(xb), _t(yb), k, chunk=chunk)
    d_j, i_j = JK.knn_points(jnp.asarray(xb), jnp.asarray(yb), k,
                             chunk=chunk)
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    _close(d_t, d_j)
    _close(TK.knn_gather(_t(yb), i_t), JK.knn_gather(jnp.asarray(yb), i_j))


@pytest.mark.parametrize("squared", [True, False])
def test_chamfer_matches_jax(squared):
    x, y = _clouds(400, 250, 3)
    got = TK.chamfer_distance(_t(x), _t(y), squared=squared)
    want = JK.chamfer_distance(jnp.asarray(x), jnp.asarray(y),
                               squared=squared)
    for a, b in zip(got, want):
        _close(a, b)


# --------------------------------------------------------------- mesh IO
def _mesh(seed=4):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(40, 3)).astype(np.float32),
            rng.integers(0, 40, (60, 3)).astype(np.int32))


def test_save_obj_is_jax_bytes_and_round_trips(tmp_path):
    v, f = _mesh()
    TTM.save_obj(tmp_path / "t.obj", torch.from_numpy(v), f)
    JTM.save_obj(tmp_path / "j.obj", v, f)
    assert (tmp_path / "t.obj").read_bytes() == \
        (tmp_path / "j.obj").read_bytes()
    v2, f2 = TTM.load_obj(tmp_path / "t.obj")
    np.testing.assert_array_equal(v2, v)
    np.testing.assert_array_equal(f2, f)
    jv, jf = JTM.load_obj(tmp_path / "t.obj")
    np.testing.assert_array_equal(v2, jv)
    np.testing.assert_array_equal(f2, jf)


@pytest.mark.parametrize("colors", ["none", "float", "uint8"])
def test_save_ply_is_jax_bytes_and_round_trips(tmp_path, colors):
    v, _ = _mesh(5)
    c = {"none": None,
         "float": np.clip(v * 0.5 + 0.5, 0, 1),
         "uint8": np.random.default_rng(6).integers(0, 256, v.shape
                                                    ).astype(np.uint8)
         }[colors]
    TPC.save_ply(tmp_path / "t.ply", torch.from_numpy(v), c)
    JPC.save_ply(tmp_path / "j.ply", v, c)
    assert (tmp_path / "t.ply").read_bytes() == \
        (tmp_path / "j.ply").read_bytes()
    p, cc = TPC.load_ply(tmp_path / "t.ply")
    np.testing.assert_array_equal(p, v)
    jp, jc = JPC.load_ply(tmp_path / "t.ply")
    np.testing.assert_array_equal(p, jp)
    if c is None:
        assert cc is None and jc is None
    else:
        np.testing.assert_array_equal(cc, jc)
        np.testing.assert_array_equal(cc, JU.img_to_uint8(c)
                                      if colors == "uint8"
                                      else (c * 255).astype(np.uint8))


# ------------------------------------------------------------- image IO
@pytest.mark.parametrize("shape", [(13, 9, 3), (13, 9), (6, 4, 4),
                                   (5, 3, 1)])
@pytest.mark.parametrize("dtype", ["float", "uint8"])
def test_png_matches_jax_save_image(tmp_path, shape, dtype):
    rng = np.random.default_rng(7)
    img = rng.uniform(-0.1, 1.1, shape).astype(np.float32)
    if dtype == "uint8":
        img = rng.integers(0, 256, shape).astype(np.uint8)
    save_image(tmp_path / "t.png", torch.from_numpy(img))
    # PIL writes a [h, w, 1] image as gray: the JAX path gets [h, w]
    JU.save_image(tmp_path / "j.png", img[..., 0] if shape[-1:] == (1,)
                  and len(shape) == 3 else img)
    t = np.asarray(Image.open(tmp_path / "t.png"))
    j = np.asarray(Image.open(tmp_path / "j.png"))
    np.testing.assert_array_equal(t.reshape(j.shape), j)
    np.testing.assert_array_equal(img_to_uint8(img), JU.img_to_uint8(img))


def test_gallery_matches_jax():
    rng = np.random.default_rng(8)
    frames = rng.uniform(size=(7, 12, 10, 3)).astype(np.float32)
    np.testing.assert_array_equal(gallery(torch.from_numpy(frames), 3),
                                  JPB.gallery(frames, 3))
    ragged = [rng.uniform(size=(h, 9)).astype(np.float32) for h in (5, 8)]
    np.testing.assert_array_equal(gallery(ragged, ncols=4, pad=1,
                                          pad_value=0.0),
                                  JPB.gallery(ragged, ncols=4, pad=1,
                                              pad_value=0.0))


# ----------------------------------------------------------------- Logger
def _log_calls(lg, tensor):
    lg.add("train", "loss", tensor(0.125), 0)
    lg.add("train", "loss", np.float32(0.0625), 100)
    lg.add("val", "psnr", 31.25, 7)
    lg.add_nested_dict("val", {"a": 1.5, "b": {"c": 2, "d": "skip"},
                               "e": np.float64(3.25)}, 8)
    lg.add_vector("val", "w", [0.5, 0.25, 4.0], 9)
    lg.add_imgs("vis", "rgb/x", np.full((4, 5, 3), 0.5, np.float32), 3)
    lg.save_stats()
    lg.close()


def test_logger_scalars_match_jax(tmp_path):
    _log_calls(TLogger(str(tmp_path / "t"), use_tensorboard=False),
               lambda v: torch.tensor(v))
    _log_calls(JLogger(str(tmp_path / "j"), use_tensorboard=False,
                       is_master=True), lambda v: jnp.asarray(v))
    t = (tmp_path / "t" / "scalars.jsonl").read_text().splitlines()
    j = (tmp_path / "j" / "scalars.jsonl").read_text().splitlines()
    assert t == j and len(t) == 9
    png = "imgs/vis/rgb_x_00000003.png"
    np.testing.assert_array_equal(
        np.asarray(Image.open(tmp_path / "t" / png)),
        np.asarray(Image.open(tmp_path / "j" / png)))
    lg = TLogger(str(tmp_path / "t"), use_tensorboard=False)
    lg.load_stats()
    assert lg.stats["val/w.2"] == [(9, 4.0)]
    # the figure, histogram and mesh methods work as JAX's (held against
    # it in tests/test_torch_profile_plot_viewer.py): without tensorboard
    # a histogram goes nowhere, a mesh to an OBJ file
    lg.add_histogram("a", "b", np.ones(3), 0)
    lg.add_mesh("a", "b", np.eye(3, dtype=np.float32),
                np.asarray([[0, 1, 2]]), 0)
    obj = (tmp_path / "t" / "meshes" / "a" / "b_00000000.obj").read_text()
    assert [l[0] for l in obj.splitlines()] == ["v", "v", "v", "f"]
    lg.close()
    quiet = TLogger(str(tmp_path / "q"), is_master=False)
    quiet.add("a", "b", 1.0, 0)
    quiet.close()
    assert not os.path.exists(tmp_path / "q")


# ---------------------------------------------------------------- meshing
def _volumes():
    g = np.stack(np.meshgrid(*[np.linspace(-1, 1, 21, dtype=np.float32)] * 3,
                             indexing="ij"), -1)
    sphere = np.linalg.norm(g - np.float32(0.1), axis=-1) - np.float32(0.55)
    box = np.max(np.abs(g) - np.asarray([0.5, 0.3, 0.7], np.float32), -1)
    return {"sphere": sphere.astype(np.float32),
            "box": box.astype(np.float32),
            "empty": np.ones((9, 8, 7), np.float32)}


@pytest.mark.parametrize("name", ["sphere", "box", "empty"])
def test_marching_cubes_matches_jax_native(name):
    from nr3d_lib_tpu.bindings import marching_tets_native

    vol = _volumes()[name]
    spacing = (0.1, 0.1, 0.1)
    v, f = TTM.marching_cubes(vol, 0.0, spacing)
    native = marching_tets_native(vol, 0.0)
    assert native is not None, "the JAX package's native mesher did not load"
    np.testing.assert_array_equal(v, native[0] * np.float32(0.1))
    np.testing.assert_array_equal(f, native[1])
    jv, jf = JTM.marching_cubes(vol, 0.0, spacing)
    np.testing.assert_array_equal(v, jv)
    np.testing.assert_array_equal(f, jf)
    assert (len(f) == 0) == (name == "empty")


@pytest.mark.parametrize("name", ["sphere", "box"])
def test_surface_nets_matches_jax(name):
    vol = _volumes()[name]
    v, f = TTM._surface_nets(vol, 0.05, (0.1, 0.2, 0.1))
    jv, jf = JTM._surface_nets(vol, 0.05, (0.1, 0.2, 0.1))
    np.testing.assert_array_equal(v, jv)
    np.testing.assert_array_equal(f, jf)
    assert len(v)


def test_the_port_meshes_from_its_own_build():
    """The port builds its copy of the native source into its own
    `_build/`, never into the JAX package's `csrc/`."""
    from nr3d_lib_tpu_torch import bindings

    lib = bindings.load_mcubes()
    assert os.path.dirname(lib._name) == str(bindings.BUILD_DIR)
    assert bindings.SOURCE.read_bytes() == open(os.path.join(
        os.path.dirname(__file__), "..", "csrc", "mcubes", "mcubes.cpp"),
        "rb").read()


# ------------------------------------------------------------ checkpoints
def test_sorted_ckpts_matches_jax(tmp_path):
    names = ["00000100", "ckpt_latest", "final_00000900", "ckpt_20",
             "misc", "3000", "00000005_x"]
    for n in names:
        (tmp_path / f"{n}.pt").write_bytes(b"")
        (tmp_path / f"{n}.msgpack").write_bytes(b"")
    got = [os.path.basename(p)[:-3] for p in sorted_ckpts(str(tmp_path))]
    want = [os.path.basename(p)[:-8] for p in j_sorted(str(tmp_path))]
    assert got == want
    assert got[-1] == "final_00000900" and got[-2] == "ckpt_latest"


class _Counter:
    """A registered object that is not a module: state_dict and
    load_state_dict, and a rebuild hook."""

    def __init__(self):
        self.n, self.hooked = 0, None

    def state_dict(self):
        return {"n": torch.tensor(self.n)}

    def load_state_dict(self, sd):
        self.n = int(sd["n"])

    def before_load_state_dict(self, sd):
        self.hooked = int(sd["n"])


def test_checkpoint_io_filters_hook_and_latest(tmp_path):
    lin = torch.nn.Linear(3, 2)
    opt = torch.optim.Adam(lin.parameters(), lr=1e-2)
    lin(torch.ones(1, 3)).sum().backward()
    opt.step()
    cnt = _Counter()
    cnt.n = 5
    io = CheckpointIO(str(tmp_path / "ck"))
    io.register_modules(model=lin, optimizer=opt, counter=cnt)
    io.save("00000010.pt", it=10, psnr=12.5)
    want = {k: v.clone() for k, v in lin.state_dict().items()}
    cnt.n = 7
    io.save("ckpt_final.pt", it=20)
    with torch.no_grad():
        for p in lin.parameters():
            p.zero_()
    cnt.n = 0
    extras = io.load("00000010.pt", ignore_keys=("counter",))
    assert extras == {"it": 10, "psnr": 12.5}
    assert cnt.n == 0 and cnt.hooked is None
    for k, v in lin.state_dict().items():
        assert torch.equal(v, want[k])
    extras = io.load(str(tmp_path / "ck" / "00000010.pt"),
                     only_use_keys=("counter",))
    assert cnt.n == 5 and cnt.hooked == 5
    assert io.load_latest()["it"] == 20 and cnt.n == 7
    assert opt.state_dict()["state"][0]["step"] == 1
    assert CheckpointIO(str(tmp_path / "none")).load_latest() is None
