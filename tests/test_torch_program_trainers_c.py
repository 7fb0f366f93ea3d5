"""The port's example trainers on the CPU, end to end, at
`tests/test_examples.py`'s smoke arguments (a subprocess): the dynamic
scene (the generative shapes: `test_torch_program_trainers_d.py`). Exit
code 0, the JAX script's marker, the files the JAX script writes; and
its analytic ground truth, `gt_*.png`, pixel for pixel the JAX
script's own at the same size (the JAX script run here at the same
`--hw`). Also the NeRF's hard scene with held-out views, in process (its
turntable, which `test_torch_program_trainers_b.py` covers, left out: it
takes most of the NeRF's run)."""

import json
import os

import numpy as np
import pytest
import torch

from torch_trainer_runs import read_png, run, smoke


@pytest.mark.parametrize("script,names", [
    ("train_dynamic_scene", ["gt_t-0.5.png", "gt_t+0.5.png"]),
])
def test_trainer_and_ground_truth(tmp_path, script, names):
    out = str(tmp_path / "port")
    smoke(script, out)
    ref = str(tmp_path / "jax")
    # no step: the JAX script's ground truth needs none, and a step would
    # compile its train step
    run("examples", script, ref, "--iters", "0", "--rays", "16", "--hw",
        "24")
    for name in names:
        port, jax_img = (read_png(os.path.join(d, name)) for d in (out, ref))
        assert port.shape == (24, 24, 3)
        np.testing.assert_array_equal(port, jax_img, err_msg=name)
    assert read_png(os.path.join(out, names[0])).std() > 1.0  # not blank


def test_nerf_synthetic_trainer_hard_scene(tmp_path, monkeypatch, capsys):
    """--scene hard with --eval_every 1: the held-out views' PSNR at every
    step and at the end, in the output and in scalars.jsonl."""
    from examples_torch import train_nerf_synthetic as T
    from nr3d_lib_tpu_torch import gui

    torch.set_num_threads(1)
    monkeypatch.setattr(gui, "render_turntable", lambda *a, **k: [])
    out = str(tmp_path / "run")
    res = T.main(["--cpu", "--iters", "2", "--rays", "64", "--scene", "hard",
                  "--eval_every", "1", "--out", out])
    assert "held-out-view PSNR (hard)" in capsys.readouterr().out
    with open(os.path.join(out, "scalars.jsonl")) as f:
        keys = [json.loads(line)["k"] for line in f]
    assert keys.count("val/psnr_heldout") == 3
    assert res["psnr_heldout"] > 0 and len(res["losses"]) == 2
