"""Forest (block-decomposed) fields and the renderable forest NeuS (port
of nr3d_lib_tpu/models/fields_forest.py `LoTDForestEncoding`,
`LoTDForestSDF`, `LoTDForestNeuS`, `LoTDForestNeRF` and
`LoTDForestNeuSModel`).

Each block's LoTD parameters are a row of one [n_trees, n_params] table,
`flattened_params`, in the JAX package's layout; a sample's block slot is
the `bidx` of the forest encode (B6 with a block row offset) and nablas
(B8 with it), and block-local coordinates come from
`ForestBlockSpace.normalize_coords`. Only the brick backend is ported
(the classic LoTD waits with ROADMAP.md A9). The model trains: on CUDA
the encode's and nablas' backwards are B7 and B9 with the block row
offset, on the CPU plain autograd; gradients reach `flattened_params`
through `_build_tables` (the dense levels' gather has an index-add
backward, the JAX `materialize_dense_brick_table` vjp).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.func import vjp

from nr3d_lib_tpu_torch.device import resolve_device
from nr3d_lib_tpu_torch.graphics import _scan
from nr3d_lib_tpu_torch.graphics import pack_ops as po
from nr3d_lib_tpu_torch.graphics.neus import (neus_packed_sdf_to_alpha,
                                              neus_ray_sdf_to_alpha)
from nr3d_lib_tpu_torch.graphics.neus_ray_query import _upsample_rounds
from nr3d_lib_tpu_torch.graphics.raysample import Draw, uniform_draw
from nr3d_lib_tpu_torch.models.accelerations.occgrid_forest import \
    OccGridAccelForest
from nr3d_lib_tpu_torch.models.blocks import MLP
from nr3d_lib_tpu_torch.models.fields.nerf import RadianceNet, trunc_exp
from nr3d_lib_tpu_torch.models.fields.neus import get_neus_var_ctrl
from nr3d_lib_tpu_torch.models.model_base import ModelMixin
from nr3d_lib_tpu_torch.models.spatial.forest import ForestBlockSpace
from nr3d_lib_tpu_torch.ops import lotd_brick as B

__all__ = ["LoTDForestEncoding", "LoTDForestSDF", "LoTDForestNeuS",
           "LoTDForestNeRF", "LoTDForestNeuSModel"]


def _hold(module: nn.Module, name: str, other: nn.Module) -> None:
    """Keep a reference to a module that another owner registers (the
    model's space), so that its state appears once."""
    object.__setattr__(module, name, other)


class LoTDForestEncoding(nn.Module):
    """Per-block F=2 brick tables over one shared meta. Dense levels keep
    canonical per-block vertex grids (C0-tied within a block)."""

    def __init__(self, n_trees: int, *, lotd_cfg: Optional[dict] = None,
                 seed: int = 0, device=None):
        super().__init__()
        cfg = dict(lotd_cfg or {})
        cfg.setdefault("lod_res", [8, 16, 32])
        cfg.setdefault("lod_n_feats", 2)
        cfg.setdefault("lod_types", ["Dense", "Dense", "Hash"])
        cfg.setdefault("hashmap_size", 2 ** 12)
        self.backend = cfg.pop("backend", "xla")
        if self.backend != "brick":
            raise NotImplementedError(
                f"LoTD backend {self.backend!r} is not ported yet "
                f"(ROADMAP.md A9)")
        if cfg["lod_n_feats"] != 2:
            raise ValueError("the forest's brick backend takes lod_n_feats 2")
        types = cfg["lod_types"]
        if isinstance(types, str):
            types = [types] * len(cfg["lod_res"])
        self.n_trees = int(n_trees)
        self.meta_brick = B.make_forest_meta(B.make_brick_meta(
            cfg["lod_res"], types,
            hashmap_rows=max(1, int(cfg["hashmap_size"]) // 64)))
        self.out_features = self.meta_brick.out_features
        sizes = [int(np.prod(lv.res)) * 2 if lv.kind == "dense"
                 else lv.n_rows * B.LANES for lv in self.meta_brick.levels]
        self._param_offsets = tuple(int(v) for v in np.cumsum([0] + sizes))
        for i, lv in enumerate(self.meta_brick.levels):
            if lv.kind == "dense":
                self.register_buffer(f"_dense_idx{i}", torch.as_tensor(
                    B.vertex_grid_to_brick_rows(lv).astype(np.int64),
                    device=device), persistent=False)
        gen = torch.Generator().manual_seed(seed)
        init = torch.rand((self.n_trees, self._param_offsets[-1]),
                          generator=gen)
        self.flattened_params = nn.Parameter(
            ((init * 2.0 - 1.0) * 1e-4).to(device))

    def _build_tables(self) -> torch.Tensor:
        """[n_trees·total_rows, 128] brick tables, block by block."""
        o, p = self._param_offsets, self.flattened_params
        rows = []
        for i, lv in enumerate(self.meta_brick.levels):
            pi = p[:, o[i]:o[i + 1]]
            if lv.kind == "dense":
                rows.append(pi[:, getattr(self, f"_dense_idx{i}")])
            else:
                rows.append(pi.reshape(self.n_trees, lv.n_rows, B.LANES))
        return torch.cat(rows, 1).reshape(-1, B.LANES)

    def forward(self, x_local: torch.Tensor, bidx: torch.Tensor
                ) -> torch.Tensor:
        """x_local in [-1,1] per block, bidx [N] int32; bidx < 0 → zero
        features."""
        y = B.brick_encode_batched(x_local * 0.5 + 0.5, self._build_tables(),
                                   self.meta_brick, bidx)
        return torch.where(bidx[..., None] >= 0, y, torch.zeros_like(y))

    def nablas_path(self, x_local: torch.Tensor, g_up: torch.Tensor,
                    bidx: torch.Tensor) -> torch.Tensor:
        """J_encᵀ·g_up in the [-1,1] convention (the 0.5 folds the
        [-1,1]→[0,1] rescale), zero for bidx < 0."""
        g_up = torch.where(bidx[..., None] >= 0, g_up, torch.zeros_like(g_up))
        return 0.5 * B.brick_nablas_batched(
            g_up, x_local * 0.5 + 0.5, self._build_tables(), self.meta_brick,
            bidx)


class LoTDForestSDF(nn.Module):
    """Forest SDF: a shared decoder over [x_local, per-block encoding]."""

    def __init__(self, space: ForestBlockSpace, *,
                 lotd_cfg: Optional[dict] = None,
                 decoder_cfg: Optional[dict] = None, n_geo_feat: int = 15,
                 seed: int = 0, device=None):
        super().__init__()
        _hold(self, "space", space)
        self.encoding = LoTDForestEncoding(max(space.n_trees, 1),
                                           lotd_cfg=lotd_cfg, seed=seed,
                                           device=device)
        dec = dict(decoder_cfg or {})
        dec.setdefault("D", 1)
        dec.setdefault("W", 64)
        self.decoder = MLP(self.encoding.out_features + 3, 1 + n_geo_feat,
                           **dec, seed=seed + 1, device=device)
        self.n_geo_feat = n_geo_feat

    def _local(self, x_world: torch.Tensor):
        bidx = self.space.block_of_points(x_world)
        return self.space.normalize_coords(x_world, bidx), bidx

    def _dec(self, x_local: torch.Tensor, h_enc: torch.Tensor):
        out = self.decoder(torch.cat([x_local, h_enc], -1))
        return out[..., 0], out[..., 1:]

    def forward_sdf(self, x_world: torch.Tensor) -> Dict[str, torch.Tensor]:
        x_local, bidx = self._local(x_world)
        sdf, h = self._dec(x_local, self.encoding(x_local, bidx))
        return {"sdf": sdf, "h": h}

    def forward_sdf_nablas(self, x_world: torch.Tensor
                           ) -> Dict[str, torch.Tensor]:
        """(sdf, h, nablas) in the split form of the JAX brick path: the
        decoder's term by `torch.func.vjp` (autograd, in any grad mode),
        the encoding's through the forest nablas (B8 with its block row
        offset), then × 2/block_size for d x_local / d x_world."""
        x_local, bidx = self._local(x_world)
        h_enc = self.encoding(x_local, bidx)
        (sdf, h), dec_vjp = vjp(self._dec, x_local, h_enc)
        gx, gh = dec_vjp((torch.ones_like(sdf), torch.zeros_like(h)))
        nab_local = gx + self.encoding.nablas_path(x_local, gh, bidx)
        nablas = nab_local * (2.0 / self.space.block_size)
        return {"sdf": sdf, "h": h, "nablas": nablas}


class LoTDForestNeuS(nn.Module):
    """Forest NeuS: the forest SDF, a radiance net over [v, n, h] and a
    learned inv_s."""

    def __init__(self, space: ForestBlockSpace, *,
                 surface_cfg: Optional[dict] = None,
                 radiance_cfg: Optional[dict] = None,
                 var_ctrl_cfg: Optional[dict] = None, seed: int = 0,
                 device=None):
        super().__init__()
        self.implicit_surface = LoTDForestSDF(space, **(surface_cfg or {}),
                                              seed=seed, device=device)
        self.radiance = RadianceNet(
            n_extra_feat=self.implicit_surface.n_geo_feat, use_nablas=True,
            use_pos=False, **(radiance_cfg or {}), seed=seed + 1,
            device=device)
        self.var_ctrl = get_neus_var_ctrl(
            **(var_ctrl_cfg or {"type": "learned"}), device=device)

    def forward_inv_s(self) -> torch.Tensor:
        return self.var_ctrl.inv_s()


class LoTDForestNeRF(nn.Module):
    """Forest NeRF: per-block encoding → density decoder → radiance."""

    def __init__(self, space: ForestBlockSpace, *,
                 lotd_cfg: Optional[dict] = None,
                 decoder_cfg: Optional[dict] = None,
                 radiance_cfg: Optional[dict] = None, n_geo_feat: int = 15,
                 seed: int = 0, device=None):
        super().__init__()
        _hold(self, "space", space)
        self.encoding = LoTDForestEncoding(max(space.n_trees, 1),
                                           lotd_cfg=lotd_cfg, seed=seed,
                                           device=device)
        dec = dict(decoder_cfg or {})
        dec.setdefault("D", 1)
        dec.setdefault("W", 64)
        self.decoder = MLP(self.encoding.out_features, 1 + n_geo_feat,
                           **dec, seed=seed + 1, device=device)
        self.radiance = RadianceNet(n_extra_feat=n_geo_feat,
                                    **(radiance_cfg or {}), seed=seed + 2,
                                    device=device)

    def forward_density(self, x_world: torch.Tensor
                        ) -> Dict[str, torch.Tensor]:
        bidx = self.space.block_of_points(x_world)
        x_local = self.space.normalize_coords(x_world, bidx)
        h = self.decoder(self.encoding(x_local, bidx))
        sigma = trunc_exp(h[..., 0]) * (bidx >= 0)
        return {"sigma": sigma, "h": h[..., 1:]}


class LoTDForestNeuSModel(nn.Module, ModelMixin):
    """Renderable forest NeuS: per-block occupancy marching (fixed steps
    or block segments), NeuS importance upsampling on the marched
    candidates, a cheap SDF pass whose transmittance picks the samples,
    a budgeted compaction into a packed buffer, and the SDF + nablas +
    radiance query and composite over the packed samples. `device=None`
    means CUDA (raises without a card); tests pass `device="cpu"`."""

    def __init__(self, space_cfg: Optional[dict] = None, *,
                 field_cfg: Optional[dict] = None,
                 accel_cfg: Optional[dict] = None, n_march_steps: int = 256,
                 step_size: Optional[float] = None,
                 march_mode: str = "fixed", max_segments: int = 32,
                 steps_per_segment: int = 16,
                 upsample_inv_s_factors: Sequence[float] = (1.0, 4.0),
                 n_importance: int = 16, upsample_inv_s: float = 64.0,
                 compression_factor: float = 0.25, seed: int = 0,
                 device=None):
        super().__init__()
        if march_mode not in ("fixed", "segments"):
            raise ValueError(f"march_mode is 'fixed' or 'segments', got "
                             f"{march_mode!r}")
        self.device = resolve_device(device)
        self.space = ForestBlockSpace(**(space_cfg or {}), device=self.device)
        if self.space.n_trees == 0:
            # a fully occupied forest until populated
            self.space.populate_from_corners(
                np.argwhere(np.ones(self.space.resolution, bool)))
        self.field = LoTDForestNeuS(self.space, **(field_cfg or {}),
                                    seed=seed, device=self.device)
        self.n_march_steps = n_march_steps
        self.step_size = step_size or (self.space.block_size / 16.0)
        self.march_mode = march_mode
        self.max_segments = int(max_segments)
        self.steps_per_segment = int(steps_per_segment)
        self.accel = OccGridAccelForest(
            self.space, step_size=self.step_size,
            max_steps_per_ray=n_march_steps, device=self.device,
            **(accel_cfg or {}))
        self.upsample_inv_s_factors = tuple(upsample_inv_s_factors)
        self.n_importance = int(n_importance)
        self.upsample_inv_s = float(upsample_inv_s)
        self.compression_factor = float(compression_factor)

    # ------------------------------------------------------------ lifecycle
    def query_occ_val(self, x_world: torch.Tensor) -> torch.Tensor:
        sdf = self.field.implicit_surface.forward_sdf(x_world)["sdf"]
        inv_s = self.field.forward_inv_s().detach()
        return torch.sigmoid(-torch.abs(sdf) * inv_s) * 4.0

    @torch.no_grad()
    def populate(self, generator: Optional[torch.Generator] = None):
        """Initialize the blocks' occupancy grids from the field (no
        generator → one seeded by 0)."""
        if generator is None:
            generator = torch.Generator(self.device).manual_seed(0)
        self.accel.init(generator, self.query_occ_val)

    def training_before_per_step(self, it: int,
                                 generator: Optional[torch.Generator] = None):
        self.field.var_ctrl.set_iter(it)
        if generator is None:
            generator = torch.Generator(self.device).manual_seed(it)
        with torch.no_grad():
            self.accel.step(it, generator, self.query_occ_val)

    def ray_test(self, rays_o: torch.Tensor, rays_d: torch.Tensor,
                 near=None, far=None) -> Dict:
        return self.space.ray_test(rays_o, rays_d, near=near, far=far)

    def _march(self, rays_o, rays_d, near, far, draw: Optional[Draw]):
        if self.march_mode == "segments":
            return self.accel.ray_march_segmented(
                rays_o, rays_d, near, far, max_segments=self.max_segments,
                steps_per_segment=self.steps_per_segment, draw=draw)
        u = None if draw is None else \
            draw((rays_o.shape[0], self.n_march_steps), 0.0, 1.0)
        return self.accel.ray_march(rays_o, rays_d, near, far, u=u)

    def ray_query(self, ray_tested: Dict,
                  generator: Optional[torch.Generator] = None,
                  with_rgb: bool = True, draw: Optional[Draw] = None
                  ) -> Tuple[Dict, Dict]:
        """Render the tested rays. A `generator` (or a `draw` callable,
        which takes precedence) perturbs the march and then each upsample
        round, the order in which the JAX version splits its key; neither
        renders unperturbed."""
        if draw is None and generator is not None:
            draw = uniform_draw(generator)
        rays_o, rays_d = ray_tested["rays_o"], ray_tested["rays_d"]
        near, far, ray_mask = ray_tested["near"], ray_tested["far"], \
            ray_tested["mask"]
        t, _, _, smask = self._march(rays_o, rays_d, near, far, draw)
        r = t.shape[0]
        surface = self.field.implicit_surface

        def sdf_fn(x):
            return surface.forward_sdf(x)["sdf"]

        # importance upsampling on world-space rays (the field maps each
        # sample into its block)
        t, valid = _upsample_rounds(sdf_fn, rays_o, rays_d, t, smask, far,
                                    self.upsample_inv_s,
                                    self.upsample_inv_s_factors,
                                    self.n_importance, draw)
        s = t.shape[1]
        inv_s = self.field.forward_inv_s()
        live = valid & ray_mask[:, None]
        with torch.no_grad():
            # cheap SDF pass → transmittance → keep mask → per-ray budget
            x = rays_o[:, None, :] + rays_d[:, None, :] * t[..., None]
            sdf_d = torch.where(valid, sdf_fn(x.reshape(r * s, 3))
                                .reshape(r, s), torch.full_like(t, 1e4))
            alpha_d = neus_ray_sdf_to_alpha(sdf_d, inv_s, append_cdf_1=True)
            alpha_d = torch.where(live, alpha_d, torch.zeros_like(alpha_d))
            trans = _scan.cumprod(torch.cat(
                [torch.ones_like(alpha_d[:, :1]), 1.0 - alpha_d[:, :-1]],
                -1), -1)
            keep = live & (trans > 1e-4)
            capacity = max(int(r * s * self.compression_factor), r)
            budget = max(capacity // r, 1)
            rank = torch.cumsum(keep.to(torch.int32), -1) - 1
            keep = keep & (rank < budget)
        t_p, ridx = po.dense_to_packed(t, keep, capacity)
        vmask = ridx < r
        sel = torch.clamp(ridx, max=r - 1).long()
        x_p = rays_o[sel] + rays_d[sel] * t_p[:, None]

        out = surface.forward_sdf_nablas(x_p)
        sdf_p = torch.where(vmask, out["sdf"], torch.full_like(t_p, 1e4))
        alpha_p = torch.where(vmask, neus_packed_sdf_to_alpha(
            sdf_p, inv_s, ridx, append_cdf_1=True), torch.zeros_like(t_p))
        vw = po.packed_alpha_to_vw(alpha_p, ridx)
        acc = po.packed_sum(vw, ridx, r)
        depth = po.packed_sum(vw * t_p, ridx, r) / torch.clamp(acc, min=1e-10)
        zero_r = torch.zeros_like(acc)
        rendered = {"mask_volume": torch.where(ray_mask, acc, zero_r),
                    "depth_volume": torch.where(ray_mask, depth, zero_r)}
        if with_rgb:
            rgb = self.field.radiance(None, rays_d[sel], out["nablas"],
                                      out["h"])
            rgb = po.packed_sum(vw[:, None] * rgb, ridx, r)
            rendered["rgb_volume"] = torch.where(ray_mask[:, None], rgb,
                                                 torch.zeros_like(rgb))
        nrm = po.packed_sum(vw[:, None] * out["nablas"], ridx, r)
        rendered["normals_volume"] = torch.where(ray_mask[:, None], nrm,
                                                 torch.zeros_like(nrm))
        vb = {"t_packed": t_p, "ridx": ridx, "alpha_packed": alpha_p,
              "vw_packed": vw, "sdf_packed": sdf_p,
              "nablas_packed": out["nablas"], "x_packed": x_p,
              "ray_mask": ray_mask, "n_compact": torch.sum(vmask),
              "n_marched": torch.sum(smask)}
        return rendered, vb
