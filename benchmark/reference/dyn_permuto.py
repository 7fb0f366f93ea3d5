"""Plain time-conditioned NeuS over a 4D permutohedral lattice in the cell
layout: the lattice, the (x, t) SDF and radiance, the dense query with its
upsample rounds, and the training step (MSE + eikonal, clipped Adam).

The lattice is the permutohedral lattice of Adams, Baek and Davis (2010)
as PermutoSDF (Rosu and Behnke, CVPR 2023) encodes with it. At each
level a point p ∈ [0, 1]^d, scaled by the level's resolution, is
elevated onto the hyperplane Σ = 0 of R^(d+1), rounded coordinate by
coordinate to the nearest point whose coordinates are multiples of d+1
(the remainder-0 point, fixed up so that they sum to 0), and the ranking
of the remainder decides which of that cell's (d+1)! simplices holds the
point; its d+1 vertices blend by barycentric weights.

The cell layout stores each remainder-0 point (a cell) as 2^(d+1) vertex
slots of F values: vertex k of a simplex is the base point plus k, less
d+1 in the coordinates whose rank is at least d+1−k, and those
coordinates' bits name its slot. A row of the unpacked table holds 256
values, so two cells of d = 4 at F = 4. A coarse level whose reachable
cells fit its row budget indexes them bijectively over the box of their
first d coordinates over d+1 (a dense level); every other level hashes
the base point's first d coordinates with the Instant-NGP XOR-primes
(the cell index modulo the level's cells). The table's values are
rounded to bfloat16 (two to a 32-bit word in the layout's packed form),
straight-through for the gradient. Every operation is a gather, a
product or a sum, so autograd gives the nablas and their second order.

The field is nr3d_lib's dynamic permuto NeuS: the lattice sees (x·½ + ½,
t·½ + ½), the SDF decoder sees [x, features] and adds the sphere |x| − r
(r = 0.5, the field's default), the radiance net sees [x, SH4(v),
nablas, h]. The query is nr3d_lib's dense NeuS query: stratified coarse
samples between the box's near and far, upsample rounds at growing
sharpness by the logistic CDF, and every final slot through the field.

Departures from the published descriptions, each as the program
defines it: the elevation sums the scaled coordinates from the last one
and its factors are float32 values; a rounding tie goes down and rank
ties break by index, so that a point picks the same simplex as the
program; negative coordinates enter the hash as 32-bit two's
complement. The occupancy grids that the program keeps by time key are
read by nothing this query computes, so the reference keeps none.

Uniform draws come from the caller's generator in the order the query
defines: the coarse jitter [R, n_coarse], then one [R, n_importance]
draw a round. Weights are named as the program's state dict names them.
Nothing here imports the program under test.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from reference.common import (BIG_SDF, CDF_EPS, Adam, Draws, fill_mlp, mlp,
                              mlp_shapes, ray_box, sample_pdf, sh4,
                              uniform_draw, vis_weights)

TABLE = "field.implicit_surface.bank.flattened_params"
DECODER = "field.implicit_surface.decoder"
RADIANCE = "field.radiance.mlp"
LN_S = "field.var_ctrl.ln_s"

HASH_PRIMES = (1, 2654435761, 805459861, 3674653429, 2097192037, 1434869437,
               2165219737)
U32 = 0xFFFFFFFF
ROW_VALUES = 256      # unpacked values a table row holds
N_FEAT = 4
RADIUS = 0.5          # the SDF's sphere residual (the field's radius_init)
CHUNK_RAYS = 4096     # rays a chunk of the training pass


# --------------------------------------------------------------- lattice
@dataclass(frozen=True)
class Level:
    scale: float
    n_rows: int
    row_offset: int
    box_lo: Optional[Sequence[int]]     # a dense level's box, else None
    box_dims: Optional[Sequence[int]]


def elevation_factors(d: int) -> List[float]:
    """The hyperplane factors (d+1)·√(2/3) / √((i+1)(i+2)), as float32."""
    inv_std = np.float32((d + 1) * math.sqrt(2.0 / 3.0))
    base = np.asarray([1.0 / math.sqrt((i + 1) * (i + 2)) for i in range(d)],
                      np.float32)
    return [float(v) for v in (base * inv_std).astype(np.float32)]


def make_levels(d: int, res_list: Sequence[float], rows: int
                ) -> List[Level]:
    """The levels: a level whose reachable cells over p ∈ [0, 1]^d fit
    `rows` rows is dense. The range of the cells' first d coordinates
    comes from the elevation's exact factors (each elevated coordinate
    is linear in the nonnegative scaled ones), widened by one for the
    rounding and the sum fix-up."""
    cells_per_row = ROW_VALUES // ((1 << (d + 1)) * N_FEAT)
    sf = [(d + 1) * math.sqrt(2.0 / 3.0) / math.sqrt((i + 1) * (i + 2))
          for i in range(d)]
    levels, offset = [], 0
    for res in res_list:
        s = float(np.float32(res))
        top = [s * sf[i] for i in range(d)]         # each factor's largest
        lo, hi = [], []
        for i in range(d):
            biggest = sum(top[i:])
            smallest = -i * top[i - 1] if i else 0.0
            lo.append(math.floor(smallest / (d + 1) + 0.5) - 1)
            hi.append(math.ceil(biggest / (d + 1) - 0.5) + 1)
        dims = [b - a + 1 for a, b in zip(lo, hi)]
        n_cells = int(np.prod(dims))
        if n_cells <= rows * cells_per_row:
            n = -(-n_cells // cells_per_row)
            levels.append(Level(s, n, offset, lo, dims))
        else:
            n = rows
            levels.append(Level(s, n, offset, None, None))
        offset += n
    return levels


def _mul_u32(a: torch.Tensor, prime: int) -> torch.Tensor:
    """(a · prime) mod 2^32 for int64 a in [0, 2^32), in 16-bit halves of
    the prime so that no product leaves int64."""
    lo = a * (prime & 0xFFFF)
    hi = ((a * (prime >> 16)) & 0xFFFF) << 16
    return (lo + hi) & U32


def _level(p: torch.Tensor, table_flat: torch.Tensor, lv: Level, d: int):
    """One level's features [N, F] at p [N, d]."""
    sf = elevation_factors(d)
    cf = [p[:, a] * lv.scale * sf[a] for a in range(d)]
    suffix = [None] * d                      # Σ_{j ≥ i} cf_j, from the last
    suffix[d - 1] = cf[d - 1]
    for i in range(d - 2, -1, -1):
        suffix[i] = suffix[i + 1] + cf[i]
    zero = torch.zeros_like(cf[0])
    elev = torch.stack([suffix[0]] + [(suffix[i] if i < d else zero)
                                      - i * cf[i - 1]
                                      for i in range(1, d + 1)], -1)
    e = elev.detach()
    up = torch.ceil(e / (d + 1)) * (d + 1)
    down = torch.floor(e / (d + 1)) * (d + 1)
    base = torch.where(up - e < e - down, up, down)
    total = torch.round(base.sum(-1) / (d + 1)).to(torch.int64)
    rest = e - base
    idx = torch.arange(d + 1, device=p.device)
    ahead = (rest[:, :, None] < rest[:, None, :]) | \
        ((rest[:, :, None] == rest[:, None, :]) &
         (idx[None, :, None] > idx[None, None, :]))
    rank = ahead.sum(-1) + total[:, None]
    under, over = rank < 0, rank > d
    rank = torch.where(under, rank + d + 1, torch.where(over, rank - d - 1,
                                                        rank))
    base = base + (under.to(base.dtype) - over.to(base.dtype)) * (d + 1)

    # barycentric weights from the remainder ordered by rank
    rem = (elev - base) / (d + 1)
    by_rank = torch.empty_like(rank).scatter_(
        1, rank, idx.expand_as(rank).contiguous())
    r_sorted = rem.gather(1, by_rank)                # [N, d+1], rank order
    w0 = (r_sorted[:, d] + 1.0) - r_sorted[:, 0]
    bary = torch.stack([w0] + [r_sorted[:, d - k] - r_sorted[:, d + 1 - k]
                               for k in range(1, d + 1)], -1)

    # the cell of the base point and each vertex's slot in it
    base_i = base.to(torch.int64)
    cells_per_row = ROW_VALUES // ((1 << (d + 1)) * N_FEAT)
    if lv.box_dims is not None:
        k = torch.div(base_i, d + 1, rounding_mode="floor")
        cell = torch.zeros_like(k[:, 0])
        for i in range(d):
            ki = (k[:, i] - lv.box_lo[i]).clamp(0, lv.box_dims[i] - 1)
            cell = cell * lv.box_dims[i] + ki
    else:
        u = base_i & U32
        h = _mul_u32(u[:, 0], HASH_PRIMES[0])
        for i in range(1, d):
            h = h ^ _mul_u32(u[:, i], HASH_PRIMES[i % len(HASH_PRIMES)])
        cell = h % (lv.n_rows * cells_per_row)
    first_slot = (cell // cells_per_row + lv.row_offset) * \
        (ROW_VALUES // N_FEAT) + (cell % cells_per_row) * (1 << (d + 1))
    verts = torch.arange(d + 1, device=p.device)
    moved = rank[:, None, :] >= (d + 1 - verts)[None, :, None]   # [N, k, i]
    slot = (moved.to(torch.int64) << idx[None, None, :]).sum(-1)
    vidx = (first_slot[:, None] + slot)[..., None] * N_FEAT + \
        torch.arange(N_FEAT, device=p.device)
    vals = table_flat[vidx]                                      # [N, k, F]
    return torch.sum(bary[..., None] * vals, 1)


def quantized(table: torch.Tensor) -> torch.Tensor:
    """The table's values rounded to bfloat16, straight-through."""
    q = table.to(torch.bfloat16).to(table.dtype)
    return table + (q - table).detach()


def encode(p: torch.Tensor, table: torch.Tensor, levels: Sequence[Level]
           ) -> torch.Tensor:
    """p [N, d] in [0, 1] → features [N, F·L] (column l·F + f) of the
    bfloat16-rounded table [rows, 256]."""
    flat = quantized(table).reshape(-1)
    return torch.cat([_level(p, flat, lv, p.shape[1]) for lv in levels], -1)


# ----------------------------------------------------------------- model
def _parts(cfg: dict):
    kw = cfg["program"]["kwargs"]
    surf = kw["field_cfg"]["surface_cfg"]
    pc = surf["permuto_cfg"]
    levels = make_levels(4, pc["res_list"], int(pc["hashmap_rows"]))
    n_geo = int(surf.get("n_geo_feat", 15))
    return kw, levels, n_geo, surf["decoder_cfg"], kw["field_cfg"][
        "radiance_cfg"]


def make_weights(cfg: dict, seed_gen: torch.Generator
                 ) -> Dict[str, torch.Tensor]:
    """Every weight from the generator in two large draws, on its device:
    the table U(±table_scale), the decoder's and the radiance MLP's
    truncated normals, ln_s = ln(inv_s)/10."""
    kw, levels, n_geo, dec, rad = _parts(cfg)
    init = cfg["init"]
    n_rows = sum(lv.n_rows for lv in levels)
    dec_shapes = mlp_shapes(3 + N_FEAT * len(levels), 1 + n_geo, dec["D"],
                            dec["W"])
    rad_shapes = mlp_shapes(3 + 16 + 3 + n_geo, 3, rad["D"], rad["W"])
    n_table = n_rows * ROW_VALUES
    draws = Draws(seed_gen, n_table,
                  sum(a * b for a, b in dec_shapes + rad_shapes))
    s = float(init["table_scale"])
    out = {TABLE: ((draws.uniform(n_table) * 2.0 - 1.0) * s).reshape(
        n_rows, ROW_VALUES)}
    fill_mlp(out, DECODER, dec_shapes, draws.normal)
    fill_mlp(out, RADIANCE, rad_shapes, draws.normal)
    out[LN_S] = torch.tensor(math.log(float(init["inv_s"])) / 10.0,
                             device=seed_gen.device)
    return out


class DynamicNeuS:
    """The plain model over a weight dict (its own copies). `dtype` is
    the precision of the MLPs' products: float32 as configured, bfloat16
    for the control. `occ` (the program's time-keyed grids) is accepted
    and not read: the query never reads them."""

    def __init__(self, cfg: dict, weights: Dict[str, torch.Tensor],
                 occ: Optional[torch.Tensor] = None, dtype=torch.float32):
        kw, self.levels, self.n_geo, dec, rad = _parts(cfg)
        n_rows = sum(lv.n_rows for lv in self.levels)
        if weights[TABLE].shape[0] != n_rows:
            raise ValueError(f"the table has {weights[TABLE].shape[0]} rows;"
                             f" the layout {n_rows}")
        self.n_dec, self.n_rad = dec["D"] + 1, rad["D"] + 1
        self.w = {k: v.detach().clone() for k, v in weights.items()}
        self.dtype = dtype
        self.q = dict(kw["ray_query_cfg"])
        self.aabb = torch.as_tensor(kw["space_cfg"]["aabb"],
                                    dtype=torch.float32)

    # ------------------------------------------------------------ field
    def inv_s(self) -> torch.Tensor:
        return torch.exp(self.w[LN_S] * 10.0)

    def sdf_h(self, x: torch.Tensor, ts: torch.Tensor):
        p = torch.cat([x * 0.5 + 0.5, ts[:, None] * 0.5 + 0.5], -1)
        h = encode(p, self.w[TABLE], self.levels)
        out = mlp(torch.cat([x, h], -1), self.w, DECODER, self.n_dec,
                  dtype=self.dtype)
        return out[:, 0] + (torch.linalg.norm(x, dim=-1) - RADIUS), \
            out[:, 1:]

    def sdf(self, x: torch.Tensor, ts: torch.Tensor,
            chunk: int = 1 << 19) -> torch.Tensor:
        return torch.cat([self.sdf_h(x[s:s + chunk], ts[s:s + chunk])[0]
                          for s in range(0, x.shape[0], chunk)])

    def field(self, x: torch.Tensor, v: torch.Tensor, ts: torch.Tensor):
        """(sdf, nablas ∂sdf/∂x, rgb), the nablas with their graph for the
        eikonal loss's second order."""
        xr = x.detach().requires_grad_(True)
        sdf, h = self.sdf_h(xr, ts)
        (nab,) = torch.autograd.grad(sdf, xr, torch.ones_like(sdf),
                                     create_graph=True)
        rgb = mlp(torch.cat([x, sh4(v), nab, h], -1), self.w, RADIANCE,
                  self.n_rad, out_act=torch.sigmoid, dtype=self.dtype)
        return sdf, nab, rgb

    def populate(self) -> None:
        """The program fills its time-keyed grids here; the query reads
        none of them."""

    # -------------------------------------------------------- the query
    @staticmethod
    def _alpha(sdf, inv_s, append: bool):
        cdf = torch.sigmoid(sdf * inv_s)
        if append:
            nxt = torch.cat([cdf[..., 1:], torch.ones_like(cdf[..., :1])], -1)
            a = (cdf - nxt) / (cdf + 1e-5)
        else:
            a = (cdf[..., :-1] - cdf[..., 1:]) / (cdf[..., :-1] + 1e-5)
        return torch.clamp(a, min=0.0)

    @staticmethod
    def _sort(t, valid, far, *pay):
        key = torch.where(valid, t, torch.full_like(t, float("inf")))
        ks, order = torch.sort(key, dim=-1, stable=True)
        vs = valid.gather(-1, order)
        return (torch.where(vs, ks, far[:, None].expand_as(ks)), vs,
                *(p.gather(-1, order) for p in pay))

    @torch.no_grad()
    def samples(self, o: torch.Tensor, d: torch.Tensor, ts: torch.Tensor,
                draw=None):
        """The sample placement (no gradient) → (o_n, d_n, t [R, S],
        valid [R, S], the box mask [R])."""
        q = self.q
        c = ((self.aabb[0] + self.aabb[1]) * 0.5).to(o.device)
        rad = ((self.aabb[1] - self.aabb[0]) * 0.5).to(o.device)
        near, far, mask = ray_box(o, d, self.aabb[0].to(o.device),
                                  self.aabb[1].to(o.device))
        o_n, d_n = (o - c) / rad, d / rad
        r, n = o.shape[0], int(q["n_coarse"])
        u = None if draw is None else draw((r, n), 0.0, 1.0)
        edges = near[:, None] + (far - near)[:, None] * torch.linspace(
            0.0, 1.0, n + 1, dtype=near.dtype, device=near.device)
        lo, hi = edges[:, :-1], edges[:, 1:]
        t = 0.5 * (lo + hi) if u is None else lo + (hi - lo) * u
        valid = torch.ones_like(t, dtype=torch.bool)

        def eval_sdf(tt):
            x = o_n[:, None, :] + d_n[:, None, :] * tt[..., None]
            return self.sdf(x.reshape(-1, 3), ts.repeat_interleave(
                tt.shape[1])).reshape(r, tt.shape[1])

        sdf = eval_sdf(t)
        for f in q["upsample_inv_s_factors"]:
            t, valid, sdf = self._sort(t, valid, far, sdf)
            sm = torch.where(valid, sdf, torch.full_like(sdf, BIG_SDF))
            w = vis_weights(self._alpha(sm, q["upsample_inv_s"] * f, False))
            uu = None if draw is None else \
                draw((r, q["n_importance"]), CDF_EPS, 1.0 - CDF_EPS)
            tn = sample_pdf(t, w, q["n_importance"], uu)
            t = torch.cat([t, tn], -1)
            valid = torch.cat([valid, torch.ones_like(tn, dtype=bool)], -1)
            sdf = torch.cat([sdf, eval_sdf(tn)], -1)
        t, valid, _ = self._sort(t, valid, far, sdf)
        return o_n, d_n, t, valid, mask

    def composite(self, o_n, d_n, d, ts, t, valid, mask):
        """Every final slot through the field, then the NeuS composite →
        (rgb [R, 3], nablas [R, S, 3])."""
        r, s = t.shape
        x = (o_n[:, None, :] + d_n[:, None, :] * t[..., None]).reshape(-1, 3)
        v = d[:, None, :].expand(r, s, 3).reshape(-1, 3)
        sdf, nab, rgb = self.field(x, v, ts.repeat_interleave(s))
        sdf = torch.where(valid, sdf.reshape(r, s),
                          torch.full_like(t, BIG_SDF))
        alpha = torch.where(valid & mask[:, None],
                            self._alpha(sdf, self.inv_s(), True),
                            torch.zeros_like(t))
        vw = vis_weights(alpha)
        rgb = torch.sum(vw[..., None] * rgb.reshape(r, s, 3), -2)
        rgb = torch.where(mask[:, None], rgb, torch.zeros_like(rgb))
        return rgb, nab.reshape(r, s, 3)

    # ------------------------------------------------------------ train
    def train(self, n_steps: int, sample, lr: float, clip: float,
              eikonal: float, data_gen: torch.Generator, lifecycle_seed: int,
              start: int = 0, adam: Optional[dict] = None):
        """`n_steps` steps from the weights, from step `start` and, where
        given, Adam's state `adam` ({"m", "v", "t"}): at each step the
        rays and their timestamps `sample(data_gen)`, the query's draws
        from `data_gen`, the loss (taken in chunks of rays, the
        gradients summed), a clipped Adam step. `lifecycle_seed` seeds
        the program's grid updates, which change nothing here. Returns
        (losses, the first step's gradients as Adam took them, the
        parameters after the last step)."""
        params = {k: v.requires_grad_(True) for k, v in self.w.items()}
        names = list(params)
        opt = Adam(params, lr, clip, state=adam)
        losses, first = [], None
        for _ in range(start, start + n_steps):
            batch = sample(data_gen)
            o, d, ts, want = batch["o"], batch["d"], batch["ts"], batch["rgb"]
            o_n, d_n, t, valid, mask = self.samples(o, d, ts,
                                                    uniform_draw(data_gen))
            r, s = t.shape
            grads = [torch.zeros_like(params[k]) for k in names]
            loss_v = 0.0
            for a in range(0, r, CHUNK_RAYS):
                z = slice(a, a + CHUNK_RAYS)
                rgb, nab = self.composite(o_n[z], d_n[z], d[z], ts[z], t[z],
                                          valid[z], mask[z])
                eik = torch.sum((torch.linalg.norm(nab, dim=-1) - 1.0) ** 2)
                loss = torch.sum((rgb - want[z]) ** 2) / (r * 3) + \
                    eikonal * eik / (r * s)
                part = torch.autograd.grad(loss, [params[k] for k in names])
                grads = [g + p for g, p in zip(grads, part)]
                loss_v += float(loss.detach())
            took = opt.step(dict(zip(names, grads)))
            losses.append(loss_v)
            if first is None:
                first = {k: g.detach().clone() for k, g in took.items()}
        return losses, first, {k: v.detach().clone()
                               for k, v in params.items()}


Model = DynamicNeuS
