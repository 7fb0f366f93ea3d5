"""Offline neural renderer (port of nr3d_lib_tpu/gui.py `NeuralRenderer`,
`render_turntable`): `model.ray_test`/`ray_query` to image buffers, on the
model's device, in ray chunks."""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from nr3d_lib_tpu_torch.utils import to_numpy

__all__ = ["NeuralRenderer", "render_turntable"]


class NeuralRenderer:
    """Renders a model's images from camera poses. `intr` defaults to a
    pinhole of focal 1.2·max(h, w) centred on the image."""

    def __init__(self, model, hw: Tuple[int, int] = (256, 256), intr=None,
                 ray_chunk: int = 8192):
        from nr3d_lib_tpu_torch.graphics.cameras import pixel_grid

        self.model = model
        self.device = model.device
        self.h, self.w = hw
        if intr is None:
            f = 1.2 * max(hw)
            intr = [[f, 0.0, self.w / 2], [0.0, f, self.h / 2],
                    [0.0, 0.0, 1.0]]
        self.intr = torch.as_tensor(intr, dtype=torch.float32).to(self.device)
        self.uv = pixel_grid(self.h, self.w, device=self.device).reshape(-1, 2)
        self.ray_chunk = ray_chunk

    @torch.no_grad()
    def render(self, c2w, generator: Optional[torch.Generator] = None,
               with_rgb: bool = True,
               ray_extras: Optional[Dict[str, float]] = None
               ) -> Dict[str, np.ndarray]:
        """c2w [4,4] → {output name: [h, w, ...] numpy}. ray_extras: scalar
        per-frame conditions broadcast to every ray, e.g. {"ts": 0.3} or
        {"bidx": 2} (names ending in "idx" as int32)."""
        from nr3d_lib_tpu_torch.graphics.cameras import pinhole_get_rays

        c2w = torch.as_tensor(c2w, dtype=torch.float32).to(self.device)
        o, d = pinhole_get_rays(self.uv, self.intr, c2w)
        outs = {}
        for s in range(0, o.shape[0], self.ray_chunk):
            rt = self.model.ray_test(o[s:s + self.ray_chunk],
                                     d[s:s + self.ray_chunk])
            n = rt["rays_o"].shape[0]
            for name, val in (ray_extras or {}).items():
                dt = torch.int32 if name.endswith("idx") else torch.float32
                rt[name] = torch.full((n,), val, dtype=dt, device=self.device)
            rendered, _ = self.model.ray_query(rt, generator=generator,
                                               with_rgb=with_rgb)
            for k, v in rendered.items():
                outs.setdefault(k, []).append(to_numpy(v))
        images = {}
        for k, chunks in outs.items():
            arr = np.concatenate(chunks, axis=0)
            images[k] = arr.reshape((self.h, self.w) + arr.shape[1:])
        return images


def render_turntable(model, *, n_frames: int = 12, radius: float = 3.0,
                     elevation: float = 0.4, hw: Tuple[int, int] = (128, 128),
                     out_dir: Optional[str] = None,
                     generator: Optional[torch.Generator] = None
                     ) -> Sequence[np.ndarray]:
    """Orbit the model and render uint8 frames; with `out_dir`, write
    `frame_XXXX.png` and the video (or its PNG sequence directory)."""
    from nr3d_lib_tpu_torch.graphics.cameras import spherical_camera_path
    from nr3d_lib_tpu_torch.logger import _write_png
    from nr3d_lib_tpu_torch.utils import img_to_uint8, save_video

    renderer = NeuralRenderer(model, hw)
    poses = spherical_camera_path(n_frames, radius, elevation,
                                  device=renderer.device)
    frames = [img_to_uint8(renderer.render(poses[i], generator=generator)
                           ["rgb_volume"]) for i in range(n_frames)]
    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
        for i, f in enumerate(frames):
            _write_png(os.path.join(out_dir, f"frame_{i:04d}.png"), f)
        save_video(os.path.join(out_dir, "turntable.mp4"), frames, fps=10)
    return frames
