"""A render cell: back-to-back frames through
`nr3d_lib_tpu_torch.gui.NeuralRenderer.render` from a seeded orbit, a
closed loop with one client, and the check of a seeded sample of the
window's frames against the plain reference.

The served occupancy grid is an input: the cells within the configured
band of the scene's surface."""

from __future__ import annotations

import random
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from harness import program
from harness.counters import Counters
from harness.driver import Driver
from harness.scene import Scene, band_grid, orbit_poses
from reference.common import derived_seed, generator, pinhole_rays


def compare(frames: List[Tuple[dict, dict]], tol: dict) -> Dict[str, float]:
    """The share of pixels, over all compared frames, whose rgb differs
    from the reference's by more than tol["rgb"] in a channel, or whose
    weighted depth Σ w·t (depth × opacity) by more than tol["depth"]."""
    bad = total = 0
    for got, ref in frames:
        d_rgb = np.abs(got["rgb"] - ref["rgb"]).max(-1)
        d_dep = np.abs(got["depth"] * got["acc"] - ref["depth"] * ref["acc"])
        bad += int(np.count_nonzero((d_rgb > tol["rgb"]) |
                                    (d_dep > tol["depth"])))
        total += d_rgb.size
    return {"bad_pixel_share": bad / total}


class RenderCell(Driver):
    def setup(self) -> None:
        from nr3d_lib_tpu_torch.gui import NeuralRenderer

        cfg, tr = self.cell.config, self.cell.traffic
        dev, seed = self.dev, self.seed
        ph = program.Phases(dev)
        self.weights = self.cell.reference.make_weights(
            cfg, generator(dev, seed, "weights"))
        self.model = model = program.build_model(cfg, dev)
        program.load_weights(model, self.weights)
        occ_cfg = cfg["occupancy"]
        self.occ = band_grid(Scene(cfg["scene"], dev),
                             cfg["program"]["kwargs"]["accel_cfg"]
                             ["resolution"], occ_cfg["band"], dev)
        share = float(self.occ.float().mean())
        if abs(share - occ_cfg["occupied_share"]) > 1e-6:
            raise ValueError(f"the band occupies {share} of the grid; the "
                             f"configuration states "
                             f"{occ_cfg['occupied_share']}")
        with torch.no_grad():
            model.accel.occ.val_grid.copy_(self.occ.float())
        if self.traced:
            self.counters = Counters(model, cfg["counted"], training=False)
        ph.mark("model")
        cam = tr["camera"]
        self.hw, self.focal = tuple(cam["hw"]), float(cam["focal"])
        h, w = self.hw
        intr = [[self.focal, 0.0, w / 2], [0.0, self.focal, h / 2],
                [0.0, 0.0, 1.0]]
        self.renderer = NeuralRenderer(model, self.hw, intr=intr,
                                       ray_chunk=tr["ray_chunk"])
        self.poses = orbit_poses(tr["n_poses"], cam["orbit_radius"],
                                 cam["elevation_deg"],
                                 generator(dev, seed, "poses"))
        self.renderer.render(self.poses[0])         # every shape a frame uses
        self.pick = random.Random(derived_seed(seed, "kept"))
        self.n, self.kept = 0, []
        ph.mark("warm-up frame")
        ph.report()

    # ------------------------------------------------------------ window
    def unit(self) -> Tuple[float, bool]:
        """One frame, request to numpy images in hand → (ms, finite).
        Keeps a uniform sample of the frames for the check (reservoir
        sampling from the seed)."""
        i = self.n
        t0 = time.perf_counter()
        out = self.renderer.render(self.poses[i % len(self.poses)])
        ms = (time.perf_counter() - t0) * 1e3
        rgb, depth = out["rgb_volume"], out["depth_volume"]
        finite = bool(np.isfinite(rgb.sum() + depth.sum()))
        k = self.cell.traffic["frames_checked"]
        frame = (i, {"rgb": rgb, "depth": depth, "acc": out["mask_volume"]})
        if len(self.kept) < k:
            self.kept.append(frame)
        else:
            j = self.pick.randrange(i + 1)
            if j < k:
                self.kept[j] = frame
        self.n += 1
        return ms, finite

    def failed(self, out) -> int:
        """Frames holding a value that is not finite."""
        return sum(not finite for _, finite in out)

    def metrics(self, out, elapsed: float) -> Dict[str, float]:
        return {"render_frames_per_s": len(out) / elapsed,
                "render_frame_ms_p95": float(np.percentile(
                    [ms for ms, _ in out], 95))}

    def free_program(self) -> None:
        self.renderer = self.model = None
        self.counters = None
        program.release(self.dev)

    # ------------------------------------------------------------- check
    def reference_frames(self, dtype=torch.float32) -> List[dict]:
        ref = self.cell.reference.Model(self.cell.config, self.weights, occ=self.occ,
                                 dtype=dtype)
        out = []
        for i, _ in self.kept:
            o, d = pinhole_rays(self.poses[i % len(self.poses)], self.hw,
                                self.focal)
            rgb, depth, acc = ref.render(o, d, self.cell.traffic[
                "reference_chunk"])
            h, w = self.hw
            out.append({"rgb": rgb.reshape(h, w, 3).cpu().numpy(),
                        "depth": depth.reshape(h, w).cpu().numpy(),
                        "acc": acc.reshape(h, w).cpu().numpy()})
        return out

    def check(self) -> Dict[str, float]:
        ref = self.reference_frames()
        return compare([(f, r) for (_, f), r in zip(self.kept, ref)],
                       self.cell.limits["tolerance"])

    def control(self) -> Dict[str, float]:
        low = self.reference_frames(torch.bfloat16)
        return compare(list(zip(low, self.reference_frames())),
                       self.cell.limits["tolerance"])


Cell = RenderCell
