"""The port's example trainers on the CPU, end to end: the forest street
and the conditional dynamic shapes at `tests/test_examples.py`'s smoke
arguments (a subprocess each). Exit code 0, the JAX script's marker and
the files the JAX script writes."""

import os

import torch

from torch_trainer_runs import read_png, smoke


def test_forest_street_trainer(tmp_path):
    out = str(tmp_path / "run")
    stdout = smoke("train_forest_street", out)
    assert "occupancy:" in stdout and "fly-through" in stdout
    payload = torch.load(os.path.join(out, "ckpts", "ckpt_final.pt"),
                         weights_only=True)
    assert set(payload) == {"model", "optimizer", "trainer", "__extras__"}
    assert payload["__extras__"]["it"] == 3
    assert "space.occupied" in payload["model"]


def test_conditional_dynamic_trainer(tmp_path):
    out = str(tmp_path / "run")
    smoke("train_conditional_dynamic", out)
    grid = read_png(os.path.join(out, "instance_time_grid.png"))
    assert grid.shape == (3 * 26 - 2, 3 * 26 - 2, 3)
