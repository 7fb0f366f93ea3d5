"""The port's NeRF trainer on the CPU, end to end, at
`tests/test_examples.py`'s smoke arguments (a subprocess on four
threads: it is the longest of the suite's files, and the last to start):
exit code 0, the JAX script's marker, the files the JAX script writes.
Most of its time is the turntable, marched through an occupancy grid
refreshed from a density three steps old (a third of each frame's
samples occupied), as the JAX script's is. The hard scene:
`test_torch_program_trainers_c.py`."""

import os

from torch_trainer_runs import read_png, smoke


def test_nerf_synthetic_trainer(tmp_path):
    out = str(tmp_path / "run")
    stdout = smoke("train_nerf_synthetic", out, threads=4)
    assert "turntable frames" in stdout
    frames = [read_png(os.path.join(out, "turntable", f"frame_{i:04d}.png"))
              for i in range(8)]
    assert all(f.shape == (128, 128, 3) for f in frames)
