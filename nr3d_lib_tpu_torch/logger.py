"""Experiment logger: scalars and images to files, and to tensorboard when
it is installed (port of nr3d_lib_tpu/logger.py `Logger`, `_write_png`).

Only the master process writes: rank 0 of `torch.distributed` when it is
initialised, else this process. Scalars always go to `scalars.jsonl`, one
JSON object a line, with or without tensorboard. A figure is logged as
its image (`plot.figure_to_image`), a histogram goes to tensorboard when
there is one, and a mesh is written as an OBJ file under `meshes/`.
"""

from __future__ import annotations

import json
import os
import pickle
from numbers import Number
from typing import Dict, Optional

import numpy as np

from nr3d_lib_tpu_torch.utils import img_to_uint8, save_image, to_numpy

__all__ = ["Logger", "master_process"]


def master_process() -> bool:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank() == 0
    return True


class Logger:
    def __init__(self, root: str, save_imgs: bool = True,
                 use_tensorboard: bool = True,
                 monitoring_dir: Optional[str] = None,
                 is_master: Optional[bool] = None):
        self.root = root
        self.is_master = master_process() if is_master is None \
            else is_master
        self.save_imgs = save_imgs
        self.stats: Dict[str, list] = {}
        self._tb = None
        self._scalar_file = None
        if self.is_master:
            os.makedirs(root, exist_ok=True)
            self._scalar_file = open(os.path.join(root, "scalars.jsonl"), "a")
            if use_tensorboard:
                try:
                    from torch.utils.tensorboard import SummaryWriter

                    self._tb = SummaryWriter(
                        monitoring_dir or os.path.join(root, "events"))
                except Exception:   # no tensorboard: the JSONL file alone
                    self._tb = None

    # ------------------------------------------------------------- scalars
    def add(self, category: str, k: str, v, it: int):
        if not self.is_master:
            return
        v = float(to_numpy(v))
        key = f"{category}/{k}"
        self.stats.setdefault(key, []).append((it, v))
        self._scalar_file.write(json.dumps({"k": key, "it": it, "v": v})
                                + "\n")
        self._scalar_file.flush()
        if self._tb is not None:
            self._tb.add_scalar(key, v, it)

    def add_nested_dict(self, category: str, d: dict, it: int,
                        prefix: str = ""):
        for k, v in d.items():
            name = f"{prefix}.{k}" if prefix else str(k)
            if isinstance(v, dict):
                self.add_nested_dict(category, v, it, prefix=name)
            elif isinstance(v, Number) or (hasattr(v, "ndim")
                                           and v.ndim == 0):
                self.add(category, name, v, it)

    def add_vector(self, category: str, k: str, vec, it: int):
        for i, v in enumerate(to_numpy(vec).reshape(-1)):
            self.add(category, f"{k}.{i}", v, it)

    # -------------------------------------------------------------- images
    def add_imgs(self, category: str, k: str, img, it: int):
        """img: [H,W,C] float in [0,1] or uint8."""
        if not self.is_master:
            return
        img = to_numpy(img)
        if img.dtype != np.uint8:
            img = (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)
        if self._tb is not None:
            self._tb.add_image(f"{category}/{k}", img, it,
                               dataformats="HWC" if img.ndim == 3 else "HW")
        if self.save_imgs:
            out_dir = os.path.join(self.root, "imgs", category)
            os.makedirs(out_dir, exist_ok=True)
            _write_png(os.path.join(
                out_dir, f"{k.replace('/', '_')}_{it:08d}.png"), img)

    def add_text(self, category: str, k: str, text: str, it: int):
        if self.is_master and self._tb is not None:
            self._tb.add_text(f"{category}/{k}", text, it)

    def add_figure(self, category: str, k: str, fig, it: int):
        """A matplotlib figure, logged as its RGB image."""
        if not self.is_master:
            return
        from nr3d_lib_tpu_torch.plot import figure_to_image

        self.add_imgs(category, k, figure_to_image(fig), it)

    def add_histogram(self, category: str, k: str, values, it: int):
        if self.is_master and self._tb is not None:
            self._tb.add_histogram(f"{category}/{k}", to_numpy(values), it)

    def add_mesh(self, category: str, k: str, vertices, faces, it: int):
        """Write the mesh to `meshes/<category>/<k>_<it>.obj`."""
        if not self.is_master:
            return
        from nr3d_lib_tpu_torch.graphics.trianglemesh import save_obj

        out_dir = os.path.join(self.root, "meshes", category)
        os.makedirs(out_dir, exist_ok=True)
        save_obj(os.path.join(out_dir, f"{k}_{it:08d}.obj"),
                 vertices, faces)

    # --------------------------------------------------------------- stats
    def save_stats(self, filename: str = "stats.p"):
        if self.is_master:
            with open(os.path.join(self.root, filename), "wb") as f:
                pickle.dump(self.stats, f)

    def load_stats(self, filename: str = "stats.p"):
        path = os.path.join(self.root, filename)
        if os.path.exists(path):
            with open(path, "rb") as f:
                self.stats = pickle.load(f)

    def close(self):
        if self._tb is not None:
            self._tb.close()
        if self._scalar_file is not None:
            self._scalar_file.close()


def _write_png(path: str, img) -> None:
    save_image(path, img_to_uint8(img))
