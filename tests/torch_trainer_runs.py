"""Shared by the port's trainer tests (`tests/test_torch_program_trainers_
*.py`): run a trainer of `examples_torch/`, or a JAX example, as a
subprocess on the CPU, as `tests/test_examples.py` runs the JAX examples,
and check what it wrote."""

import importlib
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# tests/test_examples.py's smoke arguments
SMOKE = {
    "train_nerf_synthetic": ("--iters", "3", "--rays", "128"),
    "train_neus_object": ("--iters", "3", "--rays", "128", "--mesh_res",
                          "32"),
    "train_dynamic_scene": ("--iters", "3", "--rays", "128", "--hw", "24"),
    "train_generative_shapes": ("--iters", "3", "--rays", "128", "--hw",
                                "24"),
    "train_forest_street": ("--iters", "3", "--rays", "128"),
    "train_conditional_dynamic": ("--iters", "3", "--rays", "128", "--hw",
                                  "24"),
}
MARKER = {"train_nerf_synthetic": "val PSNR", "train_neus_object": "chamfer",
          "train_dynamic_scene": "decomposition",
          "train_generative_shapes": "interpolation",
          "train_forest_street": "trained",
          "train_conditional_dynamic": "grid"}


def _threads(n: int) -> dict:
    """The suite runs in parallel workers, and torch's OpenMP threads spin
    while they wait by default, so trainers that each take every core slow
    one another by an order of magnitude: a trainer gets n threads, which
    sleep while they wait."""
    return {"OMP_NUM_THREADS": str(n), "MKL_NUM_THREADS": str(n),
            "OMP_WAIT_POLICY": "PASSIVE",
            "XLA_FLAGS": "--xla_cpu_multi_thread_eigen=false "
                         f"intra_op_parallelism_threads={n}"}


# A JAX example sets `jax_compilation_cache_dir` to a fixed directory of
# the host; run unchanged, it gets the one in $JAX_EXAMPLE_CACHE_DIR.
_JAX_EXAMPLE = """
import os, runpy, sys
import jax
_update = jax.config.update
def _cache_in_run(name, value):
    if name == "jax_compilation_cache_dir":
        value = os.environ["JAX_EXAMPLE_CACHE_DIR"]
    _update(name, value)
jax.config.update = _cache_in_run
sys.argv = sys.argv[1:]
runpy.run_path(sys.argv[0], run_name="__main__")
"""


def run(package: str, script: str, out: str, *args, threads: int = 1,
        timeout=900) -> str:
    """`python <package>/<script>.py --cpu <args> --out <out>` on `threads`
    threads; returns its standard output, asserting exit code 0. A JAX
    example (`examples/`) keeps its compilation cache in `<out>.jax_cache`.
    """
    env = dict(os.environ, JAX_PLATFORMS="cpu", **_threads(threads))
    cmd = [sys.executable, os.path.join(ROOT, package, f"{script}.py"),
           "--cpu", *args, "--out", out]
    if package == "examples":
        env["JAX_EXAMPLE_CACHE_DIR"] = out + ".jax_cache"
        cmd[1:1] = ["-c", _JAX_EXAMPLE]
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout,
                       cwd=ROOT, env=env)
    assert r.returncode == 0, f"{script} failed:\n{r.stdout}\n{r.stderr}"
    return r.stdout


def smoke(script: str, out: str, threads: int = 1) -> str:
    """The port trainer at the smoke arguments: exit code 0, the JAX
    script's marker in its output, and every file it must write."""
    stdout = run("examples_torch", script, out, *SMOKE[script],
                 threads=threads)
    assert MARKER[script] in stdout, stdout
    assert "val PSNR" in stdout, stdout
    outputs = importlib.import_module(f"examples_torch.{script}").OUTPUTS
    missing = [f for f in outputs if not os.path.isfile(os.path.join(out, f))]
    assert not missing, missing
    return stdout


def read_png(path: str) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(path))
