"""The port's NeuS object trainer on the CPU, end to end, at
`tests/test_examples.py`'s smoke arguments (a subprocess on four
threads: most of its time is the turntable's eight 128² frames):
exit code 0, the JAX script's marker, the files the JAX script writes, a
mesh inside the unit cube, and a checkpoint that loads back into the
trainer's model with its iteration and PSNR."""

import os

import torch

from torch_trainer_runs import smoke


def test_neus_object_trainer(tmp_path):
    from examples_torch import train_neus_object as T
    from nr3d_lib_tpu_torch.graphics.trianglemesh import load_obj

    torch.set_num_threads(1)
    out = str(tmp_path / "run")
    stdout = smoke("train_neus_object", out, threads=4)
    assert "mesh:" in stdout and "turntable frames" in stdout
    verts, faces = load_obj(os.path.join(out, "mesh.obj"))
    assert len(faces) > 0 and abs(verts).max() <= 1.0 + 1e-6
    tr = T.setup(T.parse(["--cpu"]), quiet=True)
    extras = tr.checkpoint_io(os.path.join(out, "ckpts")).load_latest()
    assert extras["it"] == 3 and extras["psnr"] > 0
