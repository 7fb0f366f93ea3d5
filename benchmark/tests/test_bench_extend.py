"""A later change adds a configuration, a traffic mix, a cell, a kind of
cell, a training recipe and a per-layer metric as new files and
entries: the harness finds them by name, and no file the benchmark has
is edited."""

import hashlib
import json
import shutil
from pathlib import Path

import pytest
import torch

from harness import spec

BENCH = Path(__file__).resolve().parents[1]


def _digests(root: Path):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and
            "__pycache__" not in p.parts}


@pytest.fixture
def copy(tmp_path):
    """A copy of the benchmark, its digests before any addition, and the
    BENCHMARK.json to extend."""
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = tmp_path / "benchmark"
    before = _digests(b)
    yield tmp_path, b, before, spec.load_benchmark()
    after = _digests(b)
    assert all(after[k] == v for k, v in before.items())


def _add_cell(bench, root, name, config, traffic, limits_from):
    b = root / "benchmark"
    (b / "limits" / f"{name}.json").write_text(
        (b / "limits" / f"{limits_from}.json").read_text())
    bench["workloads"].append({"name": name, "config": config,
                               "traffic": traffic, "chips": 1,
                               "why": "a test entry"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return spec.find_cell(name, spec.load_benchmark(root), root=root)


def test_new_render_cell_config_mix_and_metric(copy):
    root, b, before, bench = copy
    cfg = json.loads((b / "configs" / "nerf_w4.json").read_text())
    cfg["name"] = "nerf_w4_dummy"
    (b / "configs" / "nerf_w4_dummy.json").write_text(json.dumps(cfg))
    mix = json.loads((b / "traffic" / "frames_800_whole.json").read_text())
    mix["ray_chunk"] = 8192
    (b / "traffic" / "frames_800_c8k.json").write_text(json.dumps(mix))
    (b / "metrics" / "dummy_metric.render.py").write_text(
        "def read(ctx):\n    return 1.0\n")
    bench["configs"].append(dict(bench["configs"][1], name="nerf_w4_dummy",
                                 file="benchmark/configs/nerf_w4_dummy.json"))
    for m in bench["end_to_end"]:
        if m["name"] == "render_frames_per_s":
            m["workloads"].append("dummy_cell")
    bench["per_layer"].append({"name": "dummy_metric.render", "unit": "%",
                               "better": "higher", "source": "device_trace",
                               "layer": "kernels",
                               "moves": "render_frames_per_s",
                               "workloads": ["dummy_cell"]})
    cell = _add_cell(bench, root, "dummy_cell", "nerf_w4_dummy",
                     "frames_800_c8k", "nerf_w4_render_800")
    assert cell.config["name"] == "nerf_w4_dummy"
    assert cell.traffic["ray_chunk"] == 8192
    assert cell.readers["dummy_metric.render"](None) == 1.0
    assert cell.driver.__name__ == "RenderCell"


def test_new_kind_of_cell(copy):
    root, b, before, bench = copy
    (b / "harness" / "replay_frames.py").write_text(
        "from harness.render import RenderCell\n\n\n"
        "class Cell(RenderCell):\n    pass\n")
    mix = json.loads((b / "traffic" / "frames_800_whole.json").read_text())
    mix["kind"] = "replay_frames"
    (b / "traffic" / "frames_replayed.json").write_text(json.dumps(mix))
    cell = _add_cell(bench, root, "dummy_kind", "nerf_w4", "frames_replayed",
                     "nerf_w4_render_800")
    assert cell.driver.__module__.startswith("harness_replay_frames")


RECIPE = '''"""A NeRF recipe: colour MSE, with the time key of each ray."""
import torch


def sample(views, n, gen):
    batch = views.sample(n, gen)
    batch["ts"] = torch.rand(n, generator=gen, device=gen.device)
    return batch


def loss(model, batch, gen, cfg, rows=None):
    assert "ts" in batch
    SEEN.append(batch["o"].shape[0])
    rendered, _ = model.ray_query(model.ray_test(batch["o"], batch["d"]),
                                  generator=gen)
    rgb_l = torch.mean((rendered["rgb_volume"] - batch["rgb"]) ** 2)
    return rgb_l, rgb_l


SEEN = []
'''


def test_new_training_cell_of_another_recipe(copy):
    """A NeRF training cell: its own recipe (another loss, a batch with
    another key), configuration and mix; the harness's training driver
    sets it up, runs its window and the replayed step on the CPU."""
    root, b, before, bench = copy
    (b / "recipes" / "nerf_rgb_ts.py").write_text(RECIPE)
    cfg = json.loads((b / "configs" / "nerf_w4.json").read_text())
    cfg.update(name="nerf_w4_train", recipe="nerf_rgb_ts",
               train={"lr": 1e-2, "clip": 1.0})
    cfg["program"]["kwargs"]["accel_cfg"]["update_every"] = 2
    (b / "configs" / "nerf_w4_train.json").write_text(json.dumps(cfg))
    mix = json.loads((b / "traffic" / "train_16k.json").read_text())
    mix.update(rays_per_step=64, n_views=2, replay_updates=1)
    mix["camera"].update(hw=[16, 16], focal=22.2)
    (b / "traffic" / "train_tiny.json").write_text(json.dumps(mix))
    bench["configs"].append(dict(bench["configs"][1], name="nerf_w4_train",
                                 file="benchmark/configs/nerf_w4_train.json"))
    cell = _add_cell(bench, root, "nerf_w4_train_tiny", "nerf_w4_train",
                     "train_tiny", "neus_w4_train_16k")
    assert cell.driver.__name__ == "TrainCell"
    r = cell.driver(cell, 2_400_000_007, torch.device("cpu"))
    r.setup()
    out = r.window(0.2)
    r.free_program()
    assert cell.recipe.SEEN and set(cell.recipe.SEEN) == {64}
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert r.replay_it == 4 and r.replayed["losses"][0] > 0
