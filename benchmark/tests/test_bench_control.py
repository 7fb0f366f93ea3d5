"""The check has to fail what it is there to catch. The control — the
reference in bfloat16 in the program's place — and each fault a cell can
have, planted under the timed path, have to come out as not correct. On
the CPU at a small size; the same readings at each cell's own size on the
card come from `benchmark/calibrate.py` (PERF.md has them)."""

import pytest
import torch

import smallcells
from harness import spec

B = spec.load_benchmark()
CELLS = [w["name"] for w in B["workloads"]]
TRAIN = [c for c in CELLS if spec.find_cell(c, B).traffic["kind"] == "train"]
RENDER = [c for c in CELLS if c not in TRAIN]


def _fails(numbers: dict, cell) -> bool:
    lim = cell.limits["numbers"]
    return any(v > lim[k]["limit"] for k, v in numbers.items())


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    cell, r = smallcells.cell_run(name)
    r.setup()
    if name in RENDER:
        r.window(0.3)
    r.free_program()
    assert not _fails(r.check(), cell)
    assert _fails(r.control(), cell)


@pytest.mark.parametrize("name", TRAIN)
def test_a_step_that_leaves_the_state_unchanged(name, monkeypatch):
    from examples_torch.common import Trainer

    step = Trainer.step

    def unchanged(self, it):
        before = [p.detach().clone() for p in self.model.parameters()]
        out = step(self, it)
        with torch.no_grad():
            for p, b in zip(self.model.parameters(), before):
                p.copy_(b)
        return out

    monkeypatch.setattr(Trainer, "step", unchanged)
    assert smallcells.run_small(name)["correct"] is False


@pytest.mark.parametrize("name", TRAIN)
def test_half_the_batch_left_out(name):
    import time

    import calibrate
    import run

    cell = calibrate.half_batch(smallcells.small_cell(name))
    line = run.execute(cell, 2_400_000_001, 0.5, False, torch.device("cpu"),
                       time.perf_counter())
    assert line["correct"] is False


def _patch_render(monkeypatch, alter):
    from nr3d_lib_tpu_torch.gui import NeuralRenderer

    render = NeuralRenderer.render

    def altered(self, *a, **k):
        out = render(self, *a, **k)
        alter(out)
        return out

    monkeypatch.setattr(NeuralRenderer, "render", altered)


@pytest.mark.parametrize("name", RENDER)
def test_an_answer_altered_where_it_is_produced(name, monkeypatch):
    def alter(out):
        out["rgb_volume"][..., 0] += 0.01

    _patch_render(monkeypatch, alter)
    assert smallcells.run_small(name)["correct"] is False


@pytest.mark.parametrize("name", RENDER)
def test_half_the_rays_left_out(name, monkeypatch):
    def alter(out):
        h = out["rgb_volume"].shape[0] // 2
        out["rgb_volume"][h:] = 0.0
        out["depth_volume"][h:] = 0.0

    _patch_render(monkeypatch, alter)
    assert smallcells.run_small(name)["correct"] is False
