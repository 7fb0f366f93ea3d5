"""The port's config, utils and fmt modules against the JAX package's (and
its YAML reader and writer against PyYAML, which the JAX package reads
with).

* `config.yaml_load` gives `yaml.safe_load`'s dict on every file of
  `examples/configs/`, on the YAML of the JAX package's tests and on
  YAML 1.1's corner cases (`1e-3` a string, `5.0e-3` a float, yes/no/
  on/off bools, `~` null, octal and hex ints, sexagesimals, quoting,
  comments, flow collections across lines); `yaml_dump` writes YAML that
  both read back to the same dict; what the reader does not cover raises.
* `ConfigDict`, `merge_dicts`, `merge_dotlist`, `parse_value`, `resolve`,
  `load_config`, `save_config`, `parse_device_ids`, `BaseConfig.parse`
  and `instantiate` against JAX's on the same inputs; each of the eight
  example configs through the port's `instantiate` on the CPU, the JAX
  model's state (from JAX's `instantiate`) loaded through `bridge.py`
  strictly, every shape equal.
* utils: the nested-dict tools, `collate_nested_dict`, `torch_dtype`/
  `check_to_torch` against `jax_dtype`/`check_to_jax`,
  `tensor_statistics`, `downscale_img`, `chunked`, `import_str`,
  `backup_project`, `timeit_torch`; `load_rgb` bitwise against JAX's on
  PNGs that PIL writes (gray, gray+alpha, RGB, RGBA; the five filters
  between them) and on a JPEG (through PIL in both).
* fmt: the colours, `colored_str`, and the master-only filter.
"""

import glob
import io
import logging
import os
import struct
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from flax import nnx

from nr3d_lib_tpu import config as JC
from nr3d_lib_tpu import fmt as JF
from nr3d_lib_tpu import utils as JU
from nr3d_lib_tpu_torch import config as TC
from nr3d_lib_tpu_torch import fmt as TF
from nr3d_lib_tpu_torch import utils as TU

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "examples", "configs",
                                        "*.yaml")))
MODELS = [p for p in CONFIGS if not os.path.basename(p).startswith("_")]

# the YAML strings of tests/test_infra.py, and YAML 1.1's corner cases
YAML_CASES = {
    "infra_base": "model:\n  width: 64\n  depth: 2\n",
    "infra_child": "_base_: base.yaml\nmodel:\n  depth: 4\n  scale: "
                   "${eval:2**3}\n",
    "infra_cfg": "training:\n  lr: 0.01\nname: exp\n",
    "floats": "a: 1e-3\nb: 1.0e3\nc: 1.e-3\nd: .5\ne: 5.0e-3\nf: -1.5e+3\n"
              "g: 1.5E-3\nh: +.inf\ni: -.Inf\nj: 1_000.5\nk: 1:30.5\n"
              "l: 3.\nm: 6.0e+03\n",
    "nan": "a: .nan\n",
    "ints": "a: 017\nb: 0o17\nc: 0x1F\nd: 0b101\ne: 1_000\nf: 1:30\n"
            "g: -0\nh: +12\ni: 0\nj: 08\n",
    "bools_nulls": "a: yes\nb: No\nc: on\nd: OFF\ne: y\nf: n\ng: True\n"
                   "h: ~\ni: null\nj:\nk: Null\nl: NULL\nm: nil\n",
    "strings": "a: \"x\\ty # z\"\nb: 'it''s' # c\nc: a#b\nd: '1e-3'\n"
               "e: \"\\u00e9\\x41\"\nf: plain text here\ng: -x\n"
               "h: ${import:math.pi}\ni: 'yes'\n",
    "collections": "s: [1, {a: b, c: }, \"q\", [], {}]\nt:\n- 1\n- - 2\n"
                   "  - 3\n- a: 1\n  b:\n    c: 2\n- {x: [1,\n    2],\n"
                   "   y: z}\nu: []\nv: {}\nw:\n  - x\n  -\n  - y\n",
    "keys": "1: a\nyes: b\n~: c\n'q k': d\n1.5: e\n",
    "comments": "# head\n\na: 1   # one\n  # indented comment\nb:\n"
                "  # inside\n  c: 2\n",
    "doc_start": "---\na: [1, 2]\n",
    "seq_top": "- a\n- b: 1\n  c: [x, y]\n- - 1\n",
    "scalar_top": "42\n",
    "empty": "",
    "nested_seq_same_indent": "a:\n- 1\n- 2\nb: 3\n",
}
YAML_NOT_READ = ["a: &x 1\nb: *x\n", "a: !!str 1\n", "a: |\n  text\n",
                 "a: >\n  text\n", "a: b\n  c\n", "a: 2001-12-14\n",
                 "<<: {a: 1}\n", "a: b: c\n", "a: -\n"]


def _load_yaml(text):
    return yaml.safe_load(text)


# --------------------------------------------------------------- the reader
@pytest.mark.parametrize("path", CONFIGS,
                         ids=[os.path.basename(p) for p in CONFIGS])
def test_yaml_reader_matches_pyyaml_on_the_configs(path):
    text = open(path).read()
    assert TC.yaml_load(text) == _load_yaml(text)


@pytest.mark.parametrize("name", list(YAML_CASES))
def test_yaml_reader_matches_pyyaml(name):
    text = YAML_CASES[name]
    got, want = TC.yaml_load(text), _load_yaml(text)
    if name == "nan":
        assert np.isnan(got["a"]) and np.isnan(want["a"])
    else:
        assert got == want
        assert [type(v) for v in (got.values() if isinstance(got, dict)
                                  else [got])] == \
            [type(v) for v in (want.values() if isinstance(want, dict)
                               else [want])]


@pytest.mark.parametrize("text", YAML_NOT_READ)
def test_yaml_reader_raises_on_what_it_does_not_read(text):
    with pytest.raises(ValueError):
        TC.yaml_load(text)


def test_yaml_writer_round_trips():
    values = [TC.yaml_load(open(p).read()) for p in CONFIGS]
    values.append({
        "floats": [1.0, 2.5, 1e-05, 1e16, -0.0, 5e-3, float("inf"),
                   -float("inf"), 123456789.125, 1.0e-300],
        "scalars": [None, True, False, 0, -7, 2 ** 40],
        "strings": ["yes", "no", "on", "1e-3", "0x1F", "", " x", "a: b",
                    "#c", "null", "~", "é", "\x85\x7f\n\t\"'\\", "-",
                    "${eval:2**3}", "nr3d_lib_tpu.models.X", "2001-12-14",
                    "1:30", "..."],
        "nested": {"a": [[1, [2]], {"f": 1}, []], "b": {}, "c": {"d": {}}},
        1: "int key", "k y": [{"a": 1, "b": [1, 2]}],
    })
    for v in values:
        text = TC.yaml_dump(v)
        assert _load_yaml(text) == v
        assert TC.yaml_load(text) == v


# --------------------------------------------------------------- the configs
def test_configdict_matches_jax():
    src = {"a": 1, "b": {"c": [1, {"d": 2}], "t": (1, {"e": 3})}}
    j, t = JC.ConfigDict(src), TC.ConfigDict(src)
    assert t == j and t.b.c[1].d == j.b.c[1].d == 2
    assert isinstance(t.b.t, tuple) and isinstance(t.b.t[1], TC.ConfigDict)
    t.b.e = {"f": 3}
    assert t["b"]["e"].f == 3 and isinstance(t.b.e, TC.ConfigDict)
    t2 = t.copy()
    t2.b.c = 0
    assert t.b.c[0] == 1
    assert t.to_dict() == {**src, "b": {**src["b"], "t": [1, {"e": 3}],
                                        "e": {"f": 3}}}
    assert t.setdefault("z", {"y": 1}).y == 1
    with pytest.raises(AttributeError):
        t.missing
    del t.z
    assert "z" not in t


def test_merges_match_jax():
    base = {"model": {"lr": 0.1, "dims": [1, 2]}, "n": 5}
    dot = ["model.lr=0.5", "model.new.x=true", "n=7", "s=1e-3", "f=5.0e-3",
           "l=[1, 2]", "d={a: 1}", "q=text # c", "e=", "bad=[1, 2",
           "model.dims=~"]
    assert TC.merge_dotlist(base, dot) == JC.merge_dotlist(base, dot)
    assert base["model"]["lr"] == 0.1
    a, b = {"a": {"b": 1, "c": 2}, "x": [1]}, {"a": {"b": 9}, "y": 2}
    assert TC.merge_dicts(a, b) == JC.merge_dicts(a, b)
    for fn in (TC.merge_dicts, JC.merge_dicts):
        with pytest.raises(KeyError):
            fn(a, {"new": 1}, allow_new=False)
    for fn in (TC.merge_dotlist, JC.merge_dotlist):
        with pytest.raises(ValueError):
            fn(base, ["baditem"])
    for text in ("1", "0.5", "true", "off", "1e-3", "[1, {a: b}]", "x: 1",
                 "", "~", "'q'", "a b", "[1, 2"):
        assert TC.parse_value(text) == JC.parse_value(text), text


def test_resolve_matches_jax():
    cfg = {"a": "${eval:2**3}", "b": ["${eval:math.sqrt(4.0)}",
                                      {"c": "${eval:np.float32(1.5)}"}],
           "d": "${import:os.path.join}", "e": "plain", "f": 3}
    assert TC.resolve(cfg) == JC.resolve(cfg)
    # the JAX package's paths name the port's objects
    r = TC.resolve({"m": "${import:nr3d_lib_tpu.models.model_base."
                         "LoTDNeuSModel}"})
    assert r["m"].__module__ == "nr3d_lib_tpu_torch.models.model_base"


def test_load_and_save_config_match_jax(tmp_path):
    (tmp_path / "base.yaml").write_text(YAML_CASES["infra_base"])
    (tmp_path / "child.yaml").write_text(YAML_CASES["infra_child"])
    (tmp_path / "two.yaml").write_text(
        "_base_: [base.yaml, child.yaml]\nextra: {a: 1e-3}\n")
    for name in ("child.yaml", "two.yaml"):
        t = TC.load_config(tmp_path / name)
        assert t == JC.load_config(tmp_path / name)
        assert t.model.scale == 8
        assert TC.load_config(tmp_path / name, resolve_exprs=False) == \
            JC.load_config(tmp_path / name, resolve_exprs=False)
    for path in CONFIGS:
        assert TC.load_config(path) == JC.load_config(path)
    cfg = TC.load_config(CONFIGS[-1])
    TC.save_config(cfg, tmp_path / "t.yaml")
    JC.save_config(cfg, tmp_path / "j.yaml")
    assert TC.load_config(tmp_path / "t.yaml") == cfg == \
        JC.load_config(tmp_path / "t.yaml")
    assert TC.load_config(tmp_path / "j.yaml") == cfg


def test_baseconfig_and_device_ids_match_jax(tmp_path):
    (tmp_path / "cfg.yaml").write_text(YAML_CASES["infra_cfg"])
    argv = ["--config", str(tmp_path / "cfg.yaml"), "training.lr=0.5",
            "--device_ids", "0,1", "new.k=${eval:1+1}"]
    t, j = TC.BaseConfig().parse(argv), JC.BaseConfig().parse(argv)
    assert t == j and t.training.lr == 0.5 and t.device_ids == [0, 1]
    # --resume_dir re-reads the persisted config
    TC.save_config(t, tmp_path / "config.yaml")
    argv = ["--resume_dir", str(tmp_path), "training.n=3"]
    t, j = TC.BaseConfig().parse(argv), JC.BaseConfig().parse(argv)
    assert t == j and t.exp_dir == str(tmp_path) and t.training.n == 3
    for v in (None, 3, "0, 2,", [1, 2], (4,)):
        assert TC.parse_device_ids(v) == JC.parse_device_ids(v)


def test_instantiate_overrides_match_jax():
    cfg = {"target": "collections.OrderedDict", "param": {"a": 1}}
    assert TC.instantiate(cfg, b=2) == JC.instantiate(cfg, b=2)


def _flat(model) -> dict:
    return {"/".join(str(p) for p in k): np.asarray(v[...])
            for k, v in nnx.to_flat_state(nnx.state(model))}


@pytest.mark.parametrize("path", MODELS,
                         ids=[os.path.basename(p) for p in MODELS])
def test_config_zoo_instantiates_with_the_jax_state(path):
    from nr3d_lib_tpu_torch import bridge

    jc, tc = JC.load_config(path), TC.load_config(path)
    assert tc == jc and tc.training.lr == 5.0e-3
    assert tc.model.target.startswith("nr3d_lib_tpu.")
    with jax.enable_x64(False):
        jm = JC.instantiate(jc.model, seed=int(jc.seed))
    tm = TC.instantiate(tc.model, seed=int(tc.seed), device="cpu")
    assert type(tm).__module__.startswith("nr3d_lib_tpu_torch.")
    assert type(tm).__name__ == type(jm).__name__
    flat = _flat(jm)
    to_sd = bridge.forest_from_jax_state if "forest" in path \
        else bridge.from_jax_state
    sd = to_sd(flat)
    own = tm.state_dict()
    assert set(sd) == set(own)
    for k, v in sd.items():
        assert tuple(v.shape) == tuple(own[k].shape), k
    tm.load_state_dict(sd)                        # strict: every key


# -------------------------------------------------------------------- utils
def test_nested_dict_tools_match_jax():
    d = {"a": {"b": 1, "c": {"d": 2}}, "e": 3}
    assert TU.nested_dict_keys(d) == JU.nested_dict_keys(d)
    assert list(TU.nested_dict_items(d)) == list(JU.nested_dict_items(d))
    for keys in (("a", "c", "d"), ("a", "x"), ("e", "f"), ()):
        assert TU.nested_dict_get(d, keys, 7) == JU.nested_dict_get(d, keys,
                                                                    7)
    t, j = {"a": {}}, {"a": {}}
    TU.nested_dict_set(t, ("a", "x", "y"), 5)
    JU.nested_dict_set(j, ("a", "x", "y"), 5)
    assert t == j
    rng = np.random.default_rng(0)
    xs = [rng.normal(size=(2, 3)).astype(np.float32) for _ in range(3)]
    dicts_t = [{"x": torch.from_numpy(x), "n": 1.5, "s": "k",
                "sub": {"y": torch.from_numpy(x[0])}} for x in xs]
    dicts_j = [{"x": jnp.asarray(x), "n": 1.5, "s": "k",
                "sub": {"y": jnp.asarray(x[0])}} for x in xs]
    for stack in (True, False):
        # a number has no axis to concatenate along, in either package
        drop = (lambda d: d) if stack else \
            (lambda d: {k: v for k, v in d.items() if k != "n"})
        t = TU.collate_nested_dict([drop(d) for d in dicts_t], stack=stack)
        j = JU.collate_nested_dict([drop(d) for d in dicts_j], stack=stack)
        np.testing.assert_array_equal(t["x"].numpy(), np.asarray(j["x"]))
        np.testing.assert_array_equal(t["sub"]["y"].numpy(),
                                      np.asarray(j["sub"]["y"]))
        assert t["s"] == j["s"]
        if stack:
            np.testing.assert_array_equal(t["n"].numpy(), np.asarray(j["n"]))
    assert TU.collate_nested_dict([]) == JU.collate_nested_dict([]) == {}


def test_dtypes_and_conversion_match_jax():
    for name in ("half", "float16", "fp16", "bfloat16", "bf16", "float",
                 "float32", "fp32", "double", "float64", "int", "int32",
                 "int64", "uint8", "bool", None):
        assert str(TU.torch_dtype(name)).split(".")[-1] == \
            np.dtype(JU.jax_dtype(name)).name, name
    assert TU.torch_dtype(np.float16) == torch.float16
    assert TU.torch_dtype(torch.int8) == torch.int8
    src = {"a": [1.0, 2.0], "b": {"c": np.arange(3)}, "n": None}
    t = TU.check_to_torch(src, dtype="float16", device="cpu")
    j = JU.check_to_jax(src, dtype=jnp.float16)
    assert t["a"].dtype == torch.float16 and j["a"].dtype == jnp.float16
    assert t["b"]["c"].dtype == torch.int64 and t["n"] is None
    np.testing.assert_array_equal(t["a"].numpy(), np.asarray(j["a"]))
    ref = torch.zeros(2, dtype=torch.float64)
    assert TU.check_to_torch([1.0], ref=ref).dtype == torch.float64
    assert TU.check_to_torch(torch.ones(2)).device.type == "cpu"


def test_stats_images_and_spans_match_jax(tmp_path):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(7, 5)).astype(np.float32)
    assert TU.tensor_statistics(torch.from_numpy(x), "p") == \
        JU.tensor_statistics(x, "p")
    assert TU.tensor_statistics(np.zeros(0)) == {}
    img = rng.uniform(size=(13, 17, 3)).astype(np.float32)
    for f in (1, 2, 4):
        np.testing.assert_array_equal(TU.downscale_img(img, f),
                                      JU.downscale_img(img, f))
    assert list(TU.chunked(10, 4)) == list(JU.chunked(10, 4))
    assert TU.import_str("os.path.join") is JU.import_str("os.path.join")
    assert TU.import_str("math") is JU.import_str("math")
    assert np.array_equal(TU.img_to_uint8(img), JU.img_to_uint8(img))
    ms = TU.timeit_torch(lambda a: a @ a.T, torch.ones(32, 32), n_iters=3,
                         warmup=1)
    assert ms > 0.0


def test_backup_project_matches_jax(tmp_path):
    src = tmp_path / "src"
    for rel in ("a.py", "b.txt", "nr3d_lib_tpu_torch/m.py",
                "nr3d_lib_tpu_torch/csrc/k.cu", "nr3d_lib_tpu_torch/.h/x.py",
                "examples_torch/e.yaml", "other/o.py"):
        (src / rel).parent.mkdir(parents=True, exist_ok=True)
        (src / rel).write_text(rel)
    subdirs = ("nr3d_lib_tpu_torch", "examples_torch")
    TU.backup_project(str(tmp_path / "t"), str(src))
    JU.backup_project(str(tmp_path / "j"), str(src), subdirs,
                      (".py", ".yaml", ".sh", ".cpp", ".h", ".cu", ".cuh"))

    def tree(root):
        return sorted(os.path.relpath(os.path.join(d, f), root)
                      for d, _, fs in os.walk(root) for f in fs)

    assert tree(tmp_path / "t") == tree(tmp_path / "j")
    assert "nr3d_lib_tpu_torch/csrc/k.cu" in tree(tmp_path / "t")
    assert "other/o.py" not in tree(tmp_path / "t")


def _png_filters(data: bytes) -> set:
    """The filter types of a PNG's scanlines."""
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
    raw = zlib.decompress(b"".join(idat))
    w, h, c = hdr[0], hdr[1], {0: 1, 4: 2, 2: 3, 6: 4}[hdr[3]]
    return {raw[y * (w * c + 1)] for y in range(h)}


def test_load_rgb_matches_jax_on_pil_pngs(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(2)
    yy, xx = np.mgrid[:40, :56]
    smooth = np.stack([xx * 4, yy * 6, (xx + yy) * 2, 255 - xx], -1) \
        .astype(np.uint8)
    noise = rng.integers(0, 256, (40, 56, 4), dtype=np.uint8)
    mixed = np.concatenate([noise[:20], smooth[20:]], 0)
    modes = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4}
    seen = set()
    for name, src in (("smooth", smooth), ("noise", noise),
                      ("mixed", mixed)):
        for mode, c in modes.items():
            arr = src[..., 0] if c == 1 else src[..., :c]
            for kw in ({}, {"optimize": True}):
                path = tmp_path / f"{name}_{mode}_{len(kw)}.png"
                Image.fromarray(arr, mode).save(path, **kw)
                seen |= _png_filters(path.read_bytes())
                got, want = TU.load_rgb(str(path)), JU.load_rgb(str(path))
                assert got.dtype == np.float32 and got.shape == want.shape
                assert np.array_equal(got, want), path.name
                np.testing.assert_array_equal(
                    TU.read_png(str(path)).reshape(arr.shape), arr)
    assert seen == {0, 1, 2, 3, 4}
    # the decoder reads the encoder's output; a downscaled load; a JPEG
    TU.write_png(str(tmp_path / "w.png"), smooth)
    np.testing.assert_array_equal(TU.read_png(str(tmp_path / "w.png")),
                                  smooth)
    np.testing.assert_array_equal(
        TU.load_rgb(str(tmp_path / "w.png"), downscale=2),
        JU.load_rgb(str(tmp_path / "w.png"), downscale=2))
    Image.fromarray(smooth[..., :3]).save(tmp_path / "j.jpg")
    np.testing.assert_array_equal(TU.load_rgb(str(tmp_path / "j.jpg")),
                                  JU.load_rgb(str(tmp_path / "j.jpg")))
    with pytest.raises(ValueError, match="PNG"):
        buf = io.BytesIO()
        Image.fromarray(smooth[..., :3]).convert("P").save(buf, "png")
        TU.decode_png(buf.getvalue())


# ---------------------------------------------------------------------- fmt
def test_fmt_matches_jax():
    for name in ("GREEN", "RED", "YELLOW", "CYAN", "BOLD"):
        assert getattr(TF, name) == getattr(JF, name)
    assert TF.colored_str("x", TF.RED) == JF.colored_str("x", JF.RED)
    assert isinstance(TF.log, logging.Logger)
    handler = TF.log.handlers[0]
    record = logging.LogRecord("nr3d_torch", logging.INFO, __file__, 1,
                               "port log line", None, None)
    assert all(f.filter(record) for f in handler.filters)   # no group: master
    line = handler.format(record)
    assert line.startswith(TF.colored_str("[INFO]", TF.GREEN))
    assert line.endswith("port log line")
