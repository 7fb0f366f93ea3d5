"""The port's example trainers on the CPU, end to end, at
`tests/test_examples.py`'s smoke arguments (a subprocess): the
generative shapes (the dynamic scene:
`test_torch_program_trainers_c.py`). Exit code 0, the JAX script's
marker, the files the JAX script writes; and their analytic ground
truth, `gt_*.png`, pixel for pixel the JAX script's own at the same size
(the JAX script run here at the same `--hw`)."""

import os

import numpy as np
import pytest

from torch_trainer_runs import read_png, run, smoke


@pytest.mark.parametrize("script,names", [
    ("train_generative_shapes", [f"gt_{i}.png" for i in range(4)]),
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
