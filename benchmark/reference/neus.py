"""Plain NeuS over the F=4 brick LoTD encoding: the field, the occupancy-
marched, upsampled and compressed ray query, the occupancy grid's EMA
update, and the training step (MSE + eikonal, clipped Adam).

The query follows nr3d_lib's `march_occ_multi_upsample_compressed`:
march the occupancy grid, keep each ray's first `march_budget_factor`·S
occupied steps, upsample by NeuS's logistic CDF at growing sharpness,
drop the samples behind the early-stop transmittance, keep each ray's
first `compression_factor`·S of them, and composite the SDF, nablas and
radiance there. Uniform draws come from the caller's generator in the
order the method defines: the march's jitter, then one draw a round.

Weights are named as the program's state dict names them, so that the
harness hands the same tensors to both.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from reference import brick
from reference.common import (BIG_SDF, CDF_EPS, Adam, Draws, budgeted,
                              cell_centers, fill_mlp, march, mlp, mlp_shapes,
                              ray_box, sample_pdf, sh4, uniform_draw,
                              vis_weights)

TABLE = "field.implicit_surface.encoding.flattened_params"
DECODER = "field.implicit_surface.decoder"
RADIANCE = "field.radiance.mlp"
LN_S = "field.var_ctrl.ln_s"


def _parts(cfg: dict):
    kw = cfg["program"]["kwargs"]
    surf = kw["field_cfg"]["surface_cfg"]
    enc = surf["encoding_cfg"]
    lc = enc["lotd_cfg"]
    levels = brick.make_levels(lc["lod_res"], lc["lod_types"],
                               enc["hashmap_rows"])
    n_geo = surf["n_geo_feat"]
    dec = surf["decoder_cfg"]
    rad = kw["field_cfg"]["radiance_cfg"]
    n_enc = brick.N_FEAT * len(levels)
    return kw, levels, n_geo, dec, rad, n_enc


def make_weights(cfg: dict, seed_gen: torch.Generator
                 ) -> Dict[str, torch.Tensor]:
    """Every weight from the generator in two large draws, on its
    device: the table U(±table_scale), the SDF decoder's sphere init, the
    radiance MLP's truncated normals, ln_s = ln(inv_s)/10."""
    kw, levels, n_geo, dec, rad, n_enc = _parts(cfg)
    init = cfg["init"]
    dec_shapes = mlp_shapes(3 + n_enc, 1 + n_geo, dec["D"], dec["W"])
    rad_shapes = mlp_shapes(3 + 16 + 3 + n_geo, 3, rad["D"], rad["W"])
    n_table = sum(brick.level_param_sizes(levels))
    n_norm = sum(a * b for a, b in dec_shapes + rad_shapes)
    draws = Draws(seed_gen, n_table, n_norm)
    s = float(init["table_scale"])
    out = {TABLE: (draws.uniform(n_table) * 2.0 - 1.0) * s}
    fill_mlp(out, DECODER, dec_shapes, draws.normal,
             geometric={"radius": init["sdf_radius"],
                        "enc_std": init["enc_std"]})
    fill_mlp(out, RADIANCE, rad_shapes, draws.normal)
    out[LN_S] = torch.tensor(math.log(float(init["inv_s"])) / 10.0,
                             device=seed_gen.device)
    return out


class NeuS:
    """The plain model over a weight dict (its own copies) and, where it
    serves, the given occupancy grid (else all occupied until
    `populate`). `dtype` is the precision of the MLPs' products: float32
    as configured, bfloat16 for the control."""

    def __init__(self, cfg: dict, weights: Dict[str, torch.Tensor],
                 occ: Optional[torch.Tensor] = None, dtype=torch.float32):
        kw, self.levels, self.n_geo, dec, rad, _ = _parts(cfg)
        self.n_dec = dec["D"] + 1
        self.n_rad = rad["D"] + 1
        self.w = {k: v.detach().clone() for k, v in weights.items()}
        self.dtype = dtype
        acc = kw["accel_cfg"]
        self.res = int(acc["resolution"])
        self.n_steps = int(acc["max_steps_per_ray"])
        self.step_size = float(acc["step_size"])
        self.occ_thre = float(acc["occ_thre"])
        self.ema_decay = float(acc["ema_decay"])
        self.update_every = int(acc["update_every"])
        self.q = dict(kw["ray_query_cfg"])
        self.aabb = torch.as_tensor(kw["space_cfg"]["aabb"],
                                    dtype=torch.float32)
        dev = weights[TABLE].device
        self.val_grid = torch.ones((self.res,) * 3, device=dev) \
            if occ is None else occ.to(torch.float32)

    # ------------------------------------------------------------ field
    def inv_s(self) -> torch.Tensor:
        return torch.exp(self.w[LN_S] * 10.0)

    def sdf_h(self, x: torch.Tensor):
        table = brick.build_table(self.w[TABLE], self.levels)
        h = brick.encode(x, table, self.levels)
        out = mlp(torch.cat([x, h], -1), self.w, DECODER, self.n_dec,
                  dtype=self.dtype)
        return out[:, 0], out[:, 1:]

    def sdf(self, x: torch.Tensor, chunk: int = 1 << 20) -> torch.Tensor:
        return torch.cat([self.sdf_h(x[s:s + chunk])[0]
                          for s in range(0, x.shape[0], chunk)]) \
            if x.shape[0] else x[:, 0]

    def field(self, x: torch.Tensor, v: torch.Tensor, graph: bool):
        """(sdf, nablas ∂sdf/∂x, rgb); `graph` keeps the nablas' graph
        for the eikonal loss's second order."""
        with torch.enable_grad():
            xr = x.detach().requires_grad_(True)
            sdf, h = self.sdf_h(xr)
            (nab,) = torch.autograd.grad(sdf, xr, torch.ones_like(sdf),
                                         create_graph=graph)
        if not graph:
            sdf, h, nab = sdf.detach(), h.detach(), nab.detach()
        rgb = mlp(torch.cat([x, sh4(v), nab, h], -1), self.w, RADIANCE,
                  self.n_rad, out_act=torch.sigmoid, dtype=self.dtype)
        return sdf, nab, rgb

    # --------------------------------------------------------- the grid
    def occ(self) -> torch.Tensor:
        return self.val_grid > self.occ_thre

    @torch.no_grad()
    def occ_val(self, x: torch.Tensor) -> torch.Tensor:
        return torch.sigmoid(-torch.abs(self.sdf(x)) * self.inv_s()) * 4.0

    @torch.no_grad()
    def populate(self) -> None:
        c = cell_centers(self.res, self.val_grid.device)
        self.val_grid = torch.cat([self.occ_val(c[s:s + 65536])
                                   for s in range(0, c.shape[0], 65536)]
                                  ).reshape((self.res,) * 3)

    @torch.no_grad()
    def update_grid(self, gen: torch.Generator) -> None:
        """The EMA update: a quarter of the cells drawn uniformly and as
        many drawn from the occupied ones, a uniform point in each; every
        value decays, then takes the max with the fresh |value|."""
        r = self.res
        n = r ** 3 // 4
        dev = gen.device
        idx_u = torch.stack([torch.randint(0, r, (n,), generator=gen,
                                           device=dev) for _ in range(3)], -1)
        x_u = (idx_u.float() + torch.rand(idx_u.shape, generator=gen,
                                          device=dev)) / r * 2.0 - 1.0
        occ = self.occ().reshape(-1).float()
        wts = torch.where(occ.any(), occ, torch.ones_like(occ))
        flat = torch.multinomial(wts, n, replacement=True, generator=gen)
        idx_o = torch.stack([flat // (r * r), (flat // r) % r, flat % r], -1)
        x_o = (idx_o.float() + torch.rand(idx_o.shape, generator=gen,
                                          device=dev)) / r * 2.0 - 1.0
        idx = torch.cat([idx_u, idx_o])
        fresh = torch.abs(self.occ_val(torch.cat([x_u, x_o])))
        lin = (idx[:, 0] * r + idx[:, 1]) * r + idx[:, 2]
        g = (self.val_grid * self.ema_decay).reshape(-1)
        g.scatter_reduce_(0, lin, fresh, reduce="amax")
        self.val_grid = g.reshape((r,) * 3)

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

    def query(self, o: torch.Tensor, d: torch.Tensor, draw=None,
              graph: bool = False):
        """Render the rays → (rgb, depth, acc, nablas of every final
        slot [R, B, 3])."""
        q = self.q
        c = ((self.aabb[0] + self.aabb[1]) * 0.5).to(o.device)
        rad = ((self.aabb[1] - self.aabb[0]) * 0.5).to(o.device)
        near, far, mask = ray_box(o, d, self.aabb[0].to(o.device),
                                  self.aabb[1].to(o.device))
        o_n, d_n = (o - c) / rad, d / rad
        r = o.shape[0]
        u = None if draw is None else draw((r, self.n_steps), 0.0, 1.0)
        with torch.no_grad():
            t, _, valid = march(self.occ(), o_n, d_n, near, far,
                                self.n_steps, self.step_size, u)
            b0 = max(int(t.shape[1] * q["march_budget_factor"]), 1)
            (t,), valid = budgeted([t], valid, b0)

            def eval_sdf(tt):
                x = o_n[:, None, :] + d_n[:, None, :] * tt[..., None]
                return self.sdf(x.reshape(-1, 3)).reshape(r, tt.shape[1])

            sdf = eval_sdf(t)
            for f in q["upsample_inv_s_factors"]:
                t, valid, sdf = self._sort(t, valid, far, sdf)
                sm = torch.where(valid, sdf, torch.full_like(sdf, BIG_SDF))
                w = vis_weights(self._alpha(sm, q["upsample_inv_s"] * f,
                                            False))
                uu = None if draw is None else \
                    draw((r, q["n_importance"]), CDF_EPS, 1.0 - CDF_EPS)
                tn = sample_pdf(t, w, q["n_importance"], uu)
                t = torch.cat([t, tn], -1)
                valid = torch.cat([valid, torch.ones_like(tn, dtype=bool)],
                                  -1)
                sdf = torch.cat([sdf, eval_sdf(tn)], -1)
            t, valid, _ = self._sort(t, valid, far, sdf)
            s = t.shape[1]
            inv_s = self.inv_s()
            sdf = torch.where(valid, eval_sdf(t),
                              torch.full_like(t, BIG_SDF))
            a = self._alpha(sdf, inv_s, True)
            a = torch.where(valid & mask[:, None], a, torch.zeros_like(a))
            trans = torch.cumprod(torch.cat(
                [torch.ones_like(a[:, :1]), 1.0 - a[:, :-1]], -1).double(),
                -1).float()
            keep = valid & (trans > q["early_stop_eps"]) & (a > 0)
            b1 = max(int(s * q["compression_factor"]), 1)
            (tb,), vb = budgeted([t], keep, b1)
        x = (o_n[:, None, :] + d_n[:, None, :] * tb[..., None]).reshape(-1, 3)
        v = d[:, None, :].expand(r, b1, 3).reshape(-1, 3)
        sdf_b, nab, rgb = self.field(x, v, graph)
        sdf_b = torch.where(vb, sdf_b.reshape(r, b1),
                            torch.full_like(tb, BIG_SDF))
        alpha = torch.where(vb, self._alpha(sdf_b, self.inv_s(), True),
                            torch.zeros_like(tb))
        vw = vis_weights(alpha)
        acc = torch.sum(vw, -1)
        depth = torch.sum(vw * tb, -1) / torch.clamp(acc, min=1e-10)
        rgb = torch.sum(vw[..., None] * rgb.reshape(r, b1, 3), -2)
        zero = torch.zeros_like(acc)
        return (torch.where(mask[:, None], rgb, torch.zeros_like(rgb)),
                torch.where(mask, depth, zero), torch.where(mask, acc, zero),
                nab.reshape(r, b1, 3))

    # ----------------------------------------------------------- render
    @torch.no_grad()
    def render(self, o: torch.Tensor, d: torch.Tensor, chunk: int):
        outs = [self.query(o[s:s + chunk], d[s:s + chunk])[:3]
                for s in range(0, o.shape[0], chunk)]
        return [torch.cat(z) for z in zip(*outs)]

    # ------------------------------------------------------------ train
    def train(self, n_steps: int, sample, lr: float, clip: float,
              eikonal: float, data_gen: torch.Generator, lifecycle_seed: int,
              start: int = 0, adam: Optional[dict] = None):
        """`n_steps` steps from the weights, from step `start` and, where
        given, Adam's state `adam` ({"m", "v", "t"}): at each step the
        grid update (at multiples of `update_every`, from a generator
        seeded with lifecycle_seed + step), the rays `sample(data_gen)`,
        the query's jitter from `data_gen`, the loss, the gradients, a
        clipped Adam step. Returns (losses, the first step's gradients
        as Adam took them, the parameters after the last step)."""
        params = {k: v.requires_grad_(True) for k, v in self.w.items()}
        opt = Adam(params, lr, clip, state=adam)
        losses, first = [], None
        dev = data_gen.device
        for it in range(start, start + n_steps):
            if it % self.update_every == 0:
                self.update_grid(torch.Generator(dev).manual_seed(
                    lifecycle_seed + it))
            batch = sample(data_gen)
            rgb, _, _, nab = self.query(batch["o"], batch["d"],
                                        uniform_draw(data_gen), graph=True)
            eik = torch.mean((torch.linalg.norm(nab, dim=-1) - 1.0) ** 2)
            loss = torch.mean((rgb - batch["rgb"]) ** 2) + eikonal * eik
            names = list(params)
            grads = torch.autograd.grad(loss, [params[k] for k in names])
            took = opt.step(dict(zip(names, grads)))
            losses.append(float(loss.detach()))
            if first is None:
                first = {k: g.detach().clone() for k, g in took.items()}
        return losses, first, {k: v.detach().clone()
                               for k, v in params.items()}


Model = NeuS
