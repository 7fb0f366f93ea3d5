"""Plain NeRF over the F=4 brick LoTD encoding: the density and radiance
nets and nr3d_lib's `march_occ_compressed` query — march the occupancy
grid, keep each ray's first `compression_factor`·S occupied steps, query
the density there, keep the samples ahead of the early-stop
transmittance (at most `radiance_compression_factor` of them), query
the radiance there and composite.

Weights are named as the program's state dict names them, so that the
harness hands the same tensors to both.
"""

from __future__ import annotations

from typing import Dict

import torch

from reference import brick
from reference.common import (Draws, budgeted, fill_mlp, march, mlp,
                              mlp_shapes, ray_box, sh4, vis_weights)

TABLE = "field.encoding.flattened_params"
DECODER = "field.decoder"
RADIANCE = "field.radiance.mlp"


def _parts(cfg: dict):
    kw = cfg["program"]["kwargs"]
    f = kw["field_cfg"]
    enc = f["encoding_cfg"]
    lc = enc["lotd_cfg"]
    levels = brick.make_levels(lc["lod_res"], lc["lod_types"],
                               enc["hashmap_rows"])
    return kw, levels, f["n_geo_feat"], f["density_decoder_cfg"], \
        f["radiance_cfg"], brick.N_FEAT * len(levels)


def make_weights(cfg: dict, seed_gen: torch.Generator
                 ) -> Dict[str, torch.Tensor]:
    """Every weight from the generator in two large draws, on its
    device: the table U(±table_scale), the MLPs' truncated normals, and
    the density output's bias `sigma_bias` (σ ≈ e^bias where the
    features are small: opaque surfaces inside the served grid)."""
    kw, levels, n_geo, dec, rad, n_enc = _parts(cfg)
    dec_shapes = mlp_shapes(n_enc, 1 + n_geo, dec["D"], dec["W"])
    rad_shapes = mlp_shapes(16 + n_geo, 3, rad["D"], rad["W"])
    n_table = sum(brick.level_param_sizes(levels))
    draws = Draws(seed_gen, n_table,
                  sum(a * b for a, b in dec_shapes + rad_shapes))
    s = float(cfg["init"]["table_scale"])
    out = {TABLE: (draws.uniform(n_table) * 2.0 - 1.0) * s}
    fill_mlp(out, DECODER, dec_shapes, draws.normal)
    fill_mlp(out, RADIANCE, rad_shapes, draws.normal)
    last = f"{DECODER}.bs.{len(dec_shapes) - 1}"
    out[last][0] = float(cfg["init"]["sigma_bias"])
    return out


class NeRF:
    """The plain model over a weight dict and a served occupancy grid.
    `dtype` is the precision of the MLPs' products: float32 as
    configured, bfloat16 for the control."""

    def __init__(self, cfg: dict, weights: Dict[str, torch.Tensor],
                 occ: torch.Tensor, dtype=torch.float32):
        kw, self.levels, _, dec, rad, _ = _parts(cfg)
        self.n_dec, self.n_rad = dec["D"] + 1, rad["D"] + 1
        self.w = {k: v.detach().clone() for k, v in weights.items()}
        self.occ = occ
        self.dtype = dtype
        acc = kw["accel_cfg"]
        self.n_steps = int(acc["max_steps_per_ray"])
        self.step_size = float(acc["step_size"])
        self.q = dict(kw["ray_query_cfg"])
        self.aabb = torch.as_tensor(kw["space_cfg"]["aabb"],
                                    dtype=torch.float32)

    def density(self, x: torch.Tensor):
        table = brick.build_table(self.w[TABLE], self.levels)
        h = mlp(brick.encode(x, table, self.levels), self.w, DECODER,
                self.n_dec, dtype=self.dtype)
        return torch.exp(torch.clamp(h[:, 0], -15.0, 15.0)), h[:, 1:]

    @torch.no_grad()
    def query(self, o: torch.Tensor, d: torch.Tensor):
        q = self.q
        lo, hi = self.aabb[0].to(o.device), self.aabb[1].to(o.device)
        near, far, mask = ray_box(o, d, lo, hi)
        o_n, d_n = (o - (lo + hi) * 0.5) / ((hi - lo) * 0.5), \
            d / ((hi - lo) * 0.5)
        t, dt, sm = march(self.occ, o_n, d_n, near, far, self.n_steps,
                          self.step_size)
        r, s = t.shape
        b1 = max(int(s * q["compression_factor"]), 1)
        (t1, dt1), v1 = budgeted([t, dt], sm & mask[:, None], b1)
        x1 = o_n[:, None, :] + d_n[:, None, :] * t1[..., None]
        sigma, h = self.density(x1.reshape(-1, 3))
        sigma = sigma.reshape(r, b1)
        a1 = torch.where(v1, 1.0 - torch.exp(-sigma * dt1),
                         torch.zeros_like(sigma))
        trans = torch.cumprod(torch.cat(
            [torch.ones_like(a1[:, :1]), 1.0 - a1[:, :-1]], -1).double(),
            -1).float()
        keep = v1 & (a1 > 0) & (trans > q["early_stop_eps"])
        b2 = max(int(b1 * q["radiance_compression_factor"]), 1)
        (t2, a2, h2), v2 = budgeted([t1, a1, h.reshape(r, b1, -1)], keep,
                                    b2)
        a2 = torch.where(v2, a2, torch.zeros_like(a2))
        vw = vis_weights(a2)
        acc = torch.sum(vw, -1)
        depth = torch.sum(vw * t2, -1) / torch.clamp(acc, min=1e-10)
        v = d[:, None, :].expand(r, b2, 3).reshape(-1, 3)
        rgb = mlp(torch.cat([sh4(v), h2.reshape(r * b2, -1)], -1), self.w,
                  RADIANCE, self.n_rad, out_act=torch.sigmoid,
                  dtype=self.dtype).reshape(r, b2, 3)
        rgb = torch.sum(vw[..., None] * rgb, -2)
        zero = torch.zeros_like(acc)
        return (torch.where(mask[:, None], rgb, torch.zeros_like(rgb)),
                torch.where(mask, depth, zero), torch.where(mask, acc, zero))

    @torch.no_grad()
    def render(self, o: torch.Tensor, d: torch.Tensor, chunk: int):
        outs = [self.query(o[s:s + chunk], d[s:s + chunk])
                for s in range(0, o.shape[0], chunk)]
        return [torch.cat(z) for z in zip(*outs)]


Model = NeRF
