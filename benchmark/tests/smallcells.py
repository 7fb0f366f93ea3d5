"""Cells of BENCHMARK.json cut to a size a CPU test holds: the same
configuration, limits and code, with a small batch, small frames (the
focal scaled with them), few views, and for training an occupancy update
every other step, so that the replayed window step is step 4."""

from __future__ import annotations

import time

import torch

from harness import spec

HW = 24


def small_cell(name: str) -> spec.Cell:
    cell = spec.find_cell(name, spec.load_benchmark())
    tr = cell.traffic
    cam = tr["camera"]
    cam["focal"] = cam["focal"] * HW / cam["hw"][0]
    cam["hw"] = [HW, HW]
    if tr["kind"] == "train":
        tr.update(rays_per_step=128, n_views=2, stretch_units=2,
                  replay_updates=1)
        cell.config["program"]["kwargs"]["accel_cfg"]["update_every"] = 2
    else:
        tr.update(ray_chunk=256, n_poses=4, frames_checked=2,
                  reference_chunk=128, stretch_units=1)
    return cell


def run_small(name: str, seconds: float = 0.5, trace: bool = False,
              seed: int = 2_400_000_001) -> dict:
    """A whole run of the cell on the CPU: set-up, window, check."""
    import run

    return run.execute(small_cell(name), seed, seconds, trace,
                       torch.device("cpu"), time.perf_counter())


def cell_run(name: str, seed: int = 2_400_000_001):
    """The cell's driver on the CPU, not yet set up."""
    cell = small_cell(name)
    return cell, cell.driver(cell, seed, torch.device("cpu"))
