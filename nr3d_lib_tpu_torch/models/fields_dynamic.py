"""Dynamic (time-varying) fields (port of nr3d_lib_tpu/models/
fields_dynamic.py `DynamicPermutoConcatSDF`, `DynamicPermutoConcatNeuS`,
`EmerNeRF`, `EmerNeRFOnlyDynamic`, `emernerf_cycle_loss`): t is
concatenated onto x as a fourth permutohedral input. EmerNeRF adds a
static branch (the classic LoTD), a flow head for temporal aggregation and
a shadow head.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from nr3d_lib_tpu_torch.models.blocks import MLP
from nr3d_lib_tpu_torch.models.fields.nerf import RadianceNet, trunc_exp
from nr3d_lib_tpu_torch.models.fields.neus import ConditionedNeuS
from nr3d_lib_tpu_torch.models.fields.sdf import SphereResidualDecoder
from nr3d_lib_tpu_torch.models.grid_encodings.lotd import LoTDEncoding
from nr3d_lib_tpu_torch.models.grid_encodings.permuto import PermutoParams

__all__ = ["DynamicPermutoConcatSDF", "DynamicPermutoConcatNeuS", "EmerNeRF",
           "EmerNeRFOnlyDynamic", "emernerf_cycle_loss"]


def _ts_column(ts, x: torch.Tensor) -> torch.Tensor:
    """ts (scalar, [N] or [..., 1]) → [..., 1] matching x's batch."""
    ts = torch.as_tensor(ts, dtype=x.dtype, device=x.device)
    if ts.dim() <= 1:
        ts = ts.reshape(-1, 1)
    return ts.expand(*x.shape[:-1], 1)


class DynamicPermutoConcatSDF(SphereResidualDecoder):
    """SDF over (x, t) through a 4D permutohedral table (the classic
    lattice by default, or the cell layout)."""

    def __init__(self, *, permuto_cfg: Optional[dict] = None,
                 decoder_cfg: Optional[dict] = None, n_geo_feat: int = 15,
                 radius_init: float = 0.5, seed: int = 0, device=None):
        super().__init__()
        cfg = dict(permuto_cfg or {})
        cfg.setdefault("res_list", [8.0, 16.0, 32.0, 64.0, 128.0])
        cfg.setdefault("n_feats", 2)
        cfg.setdefault("log2_hashmap_size", 17)
        self.bank = PermutoParams(
            4, cfg["res_list"], n_feats=cfg["n_feats"],
            log2_hashmap_size=cfg["log2_hashmap_size"],
            backend=cfg.get("backend", "xla"),
            hashmap_rows=cfg.get("hashmap_rows", 4096), seed=seed,
            device=device)
        self.meta = self.bank.meta
        self._init_decoder(self.bank.out_features, decoder_cfg, n_geo_feat,
                           radius_init, seed, device)

    def _inp(self, x: torch.Tensor, ts) -> torch.Tensor:
        return torch.cat([x * 0.5 + 0.5, _ts_column(ts, x) * 0.5 + 0.5], -1)

    def forward_sdf(self, x: torch.Tensor, ts) -> Dict[str, torch.Tensor]:
        """x in [-1,1], ts in [-1,1] → {sdf, h}."""
        sdf, h = self._dec(x, self.bank(self._inp(x, ts)))
        return {"sdf": sdf, "h": h}

    def forward_sdf_nablas(self, x: torch.Tensor, ts
                           ) -> Dict[str, torch.Tensor]:
        """(sdf, h, nablas=∂sdf/∂x) at fixed t: the spatial nablas are
        the first 3 of the 4 lattice-input gradients (B13 for F=2, B16 for
        F=4 on the cell layout)."""
        return self._sdf_nablas(x, lambda xx: self._inp(xx, ts))


class DynamicPermutoConcatNeuS(ConditionedNeuS):
    """Time-conditioned NeuS field: (x, t) SDF + radiance + inv_s;
    `forward(x, v, ts)`."""

    def __init__(self, *, surface_cfg: Optional[dict] = None,
                 radiance_cfg: Optional[dict] = None,
                 var_ctrl_cfg: Optional[dict] = None, seed: int = 0,
                 device=None):
        super().__init__(DynamicPermutoConcatSDF(
            **(surface_cfg or {}), seed=seed, device=device),
            radiance_cfg, var_ctrl_cfg, seed, device)


def _dyn_bank(dcfg: Optional[dict], seed: int, device) -> PermutoParams:
    """EmerNeRF's (x, t) bank: the classic 4D lattice by default."""
    dcfg = dict(dcfg or {})
    dcfg.setdefault("res_list", [8.0, 16.0, 32.0, 64.0])
    dcfg.setdefault("n_feats", 2)
    dcfg.setdefault("log2_hashmap_size", 16)
    return PermutoParams(
        4, dcfg["res_list"], n_feats=dcfg["n_feats"],
        log2_hashmap_size=dcfg["log2_hashmap_size"],
        backend=dcfg.get("backend", "xla"),
        hashmap_rows=dcfg.get("hashmap_rows", 4096), seed=seed + 2,
        device=device)


class _EmerNeRFDynamic(nn.Module):
    """The dynamic branch shared by `EmerNeRF` and `EmerNeRFOnlyDynamic`:
    the (x, t) bank, its density decoder, its radiance and the flow head
    with temporal aggregation."""

    def _init_dynamic(self, dynamic_permuto_cfg, use_flow: bool,
                      temporal_aggregation: bool, dt: float, agg_weights,
                      n_geo_feat: int, seed: int, device) -> None:
        self.dyn_bank = _dyn_bank(dynamic_permuto_cfg, seed, device)
        self.dyn_meta = self.dyn_bank.meta
        self.dyn_decoder = MLP(self.dyn_bank.out_features, 1 + n_geo_feat,
                               D=1, W=64, seed=seed + 3, device=device)
        self.dyn_radiance = RadianceNet(n_extra_feat=n_geo_feat,
                                        seed=seed + 5, device=device)
        self.use_flow = use_flow
        self.temporal_aggregation = bool(temporal_aggregation and use_flow)
        self.dt = float(dt)
        self.agg_weights = tuple(float(w) for w in agg_weights)
        if use_flow:
            self.flow_mlp = MLP(self.dyn_bank.out_features, 6, D=2, W=64,
                                seed=seed + 6, device=device)

    def _dyn_feats(self, x: torch.Tensor, ts) -> torch.Tensor:
        return self.dyn_bank(
            torch.cat([x * 0.5 + 0.5, _ts_column(ts, x) * 0.5 + 0.5], -1))

    def query_flow(self, x: torch.Tensor, ts) -> Dict[str, torch.Tensor]:
        fl = self.flow_mlp(self._dyn_feats(x, ts))
        return {"flow_fwd": fl[..., :3], "flow_bwd": fl[..., 3:]}

    def _dynamic(self, x: torch.Tensor, ts, out: Dict,
                 generator: Optional[torch.Generator],
                 noise_u: Optional[torch.Tensor]) -> torch.Tensor:
        """The dynamic decoder's output [..., 1 + n_geo_feat]. With
        temporal aggregation: the agg_weights blend of the (t−dt·n, t,
        t+dt·n) features at the flow-warped points, n = 1.5·u for a
        training-mode draw u ∈ [0,1) [x's batch] (`noise_u`, else one
        from `generator`) or n = 1 without one (JAX: no key); the flows
        and the warped points' flow re-predictions go into `out`."""
        hd_feat = self._dyn_feats(x, ts)
        if not self.temporal_aggregation:
            return self.dyn_decoder(hd_feat)
        fl = self.flow_mlp(hd_feat)
        flow_fwd, flow_bwd = fl[..., :3], fl[..., 3:]
        out["flow_fwd"], out["flow_bwd"] = flow_fwd, flow_bwd
        ts_b = torch.as_tensor(ts, dtype=x.dtype, device=x.device)
        ts_b = ts_b.reshape(-1) if ts_b.dim() <= 1 else ts_b
        ts_b = ts_b.expand(x.shape[:-1])
        if noise_u is None and generator is not None:
            noise_u = torch.rand(ts_b.shape, generator=generator,
                                 device=generator.device).to(x.device)
        noise = torch.ones_like(ts_b) if noise_u is None else \
            1.5 * noise_u.to(x.dtype)
        x_fwd = x + flow_fwd * noise[..., None]
        x_bwd = x + flow_bwd * noise[..., None]
        h_fwd = self._dyn_feats(x_fwd, ts_b + self.dt * noise)
        h_bwd = self._dyn_feats(x_bwd, ts_b - self.dt * noise)
        w = self.agg_weights
        hd = self.dyn_decoder(w[0] * h_bwd + w[1] * hd_feat + w[2] * h_fwd)
        # cycle consistency: the warped points' own flow predictions
        out["flow_fwd_pred_bwd"] = self.flow_mlp(h_fwd)[..., 3:]
        out["flow_bwd_pred_fwd"] = self.flow_mlp(h_bwd)[..., :3]
        return hd


class EmerNeRF(_EmerNeRFDynamic):
    """Static + dynamic + flow decomposition: a static branch (the classic
    LoTD, σ_s and rgb_s), a dynamic branch over the (x, t) lattice (σ_d,
    rgb_d), a flow head (forward and backward scene flow) and a shadow
    head (a factor on the static rgb). Densities add; rgb blends by the
    density ratio."""

    def __init__(self, *, static_cfg: Optional[dict] = None,
                 dynamic_permuto_cfg: Optional[dict] = None,
                 use_flow: bool = True, use_shadow: bool = True,
                 temporal_aggregation: bool = True, dt: float = 0.02,
                 agg_weights: Tuple[float, float, float] = (0.25, 0.5, 0.25),
                 n_geo_feat: int = 15, seed: int = 0, device=None):
        super().__init__()
        scfg = dict(static_cfg or {})
        scfg.setdefault("lotd_cfg", {
            "lod_res": [16, 32, 64, 128], "lod_n_feats": 2,
            "lod_types": ["Dense", "Dense", "Hash", "Hash"],
            "hashmap_size": 2 ** 15})
        self.static_encoding = LoTDEncoding(3, lotd_cfg=scfg["lotd_cfg"],
                                            seed=seed, device=device)
        self.static_decoder = MLP(self.static_encoding.out_features,
                                  1 + n_geo_feat, D=1, W=64, seed=seed + 1,
                                  device=device)
        self._init_dynamic(dynamic_permuto_cfg, use_flow,
                           temporal_aggregation, dt, agg_weights, n_geo_feat,
                           seed, device)
        self.static_radiance = RadianceNet(n_extra_feat=n_geo_feat,
                                           seed=seed + 4, device=device)
        self.use_shadow = use_shadow
        if use_shadow:
            self.shadow_mlp = MLP(n_geo_feat, 1, D=1, W=32,
                                  output_activation="sigmoid", seed=seed + 7,
                                  device=device)

    def get_weight_reg(self, norm_type: float = 2.0) -> torch.Tensor:
        """The decoders' per-layer weight norms, concatenated."""
        items = [self.static_decoder.get_weight_reg(norm_type),
                 self.dyn_decoder.get_weight_reg(norm_type)]
        if self.use_flow:
            items.append(self.flow_mlp.get_weight_reg(norm_type))
        if self.use_shadow:
            items.append(self.shadow_mlp.get_weight_reg(norm_type))
        return torch.cat(items)

    def forward(self, x: torch.Tensor, v: Optional[torch.Tensor], ts,
                with_rgb: bool = True,
                generator: Optional[torch.Generator] = None,
                noise_u: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
        """x [N, 3] in [-1,1], v [N, 3] the view directions, ts the times
        in [-1,1] → sigma, sigma_static, sigma_dynamic (and rgb,
        rgb_static, rgb_dynamic, shadow; the flows). `generator` or
        `noise_u` draws the training-mode warp noise (see `_dynamic`)."""
        hs = self.static_decoder(self.static_encoding(x))
        sigma_s = trunc_exp(hs[..., 0])
        out: Dict[str, torch.Tensor] = {}
        hd = self._dynamic(x, ts, out, generator, noise_u)
        sigma_d = trunc_exp(hd[..., 0])
        sigma = sigma_s + sigma_d
        out.update({"sigma": sigma, "sigma_static": sigma_s,
                    "sigma_dynamic": sigma_d})
        if with_rgb:
            rgb_s = self.static_radiance(x, v, None, hs[..., 1:])
            if self.use_shadow:
                shadow = self.shadow_mlp(hd[..., 1:])
                rgb_s = rgb_s * (1.0 - shadow)
                out["shadow"] = shadow[..., 0]
            rgb_d = self.dyn_radiance(x, v, None, hd[..., 1:])
            ratio = (sigma_d / torch.clamp(sigma, min=1e-8))[..., None]
            out["rgb"] = rgb_s * (1 - ratio) + rgb_d * ratio
            out["rgb_static"] = rgb_s
            out["rgb_dynamic"] = rgb_d
        if self.use_flow and not self.temporal_aggregation:
            out.update(self.query_flow(x, ts))
        return out


class EmerNeRFOnlyDynamic(_EmerNeRFDynamic):
    """EmerNeRF without the static branch: a fully dynamic scene. Its
    outputs are `EmerNeRF`'s, with sigma == sigma_dynamic and zero static
    terms."""

    def __init__(self, *, dynamic_permuto_cfg: Optional[dict] = None,
                 use_flow: bool = True, temporal_aggregation: bool = True,
                 dt: float = 0.02,
                 agg_weights: Tuple[float, float, float] = (0.25, 0.5, 0.25),
                 n_geo_feat: int = 15, seed: int = 0, device=None):
        super().__init__()
        self._init_dynamic(dynamic_permuto_cfg, use_flow,
                           temporal_aggregation, dt, agg_weights, n_geo_feat,
                           seed, device)
        self.use_shadow = False

    def get_weight_reg(self, norm_type: float = 2.0) -> torch.Tensor:
        items = [self.dyn_decoder.get_weight_reg(norm_type)]
        if self.use_flow:
            items.append(self.flow_mlp.get_weight_reg(norm_type))
        return torch.cat(items)

    def forward(self, x: torch.Tensor, v: Optional[torch.Tensor], ts,
                with_rgb: bool = True,
                generator: Optional[torch.Generator] = None,
                noise_u: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
        out: Dict[str, torch.Tensor] = {}
        hd = self._dynamic(x, ts, out, generator, noise_u)
        sigma_d = trunc_exp(hd[..., 0])
        out.update({"sigma": sigma_d, "sigma_dynamic": sigma_d,
                    "sigma_static": torch.zeros_like(sigma_d)})
        if with_rgb:
            rgb_d = self.dyn_radiance(x, v, None, hd[..., 1:])
            out["rgb"] = rgb_d
            out["rgb_static"] = torch.zeros_like(rgb_d)
            out["rgb_dynamic"] = rgb_d
        if self.use_flow and not self.temporal_aggregation:
            out.update(self.query_flow(x, ts))
        return out


def emernerf_cycle_loss(out: Dict[str, torch.Tensor],
                        mask: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Flow cycle consistency: the backward flow predicted at the
    forward-warped point must undo the forward flow, and vice versa. The
    mean of the squared residuals (over `mask` when given)."""
    c = torch.sum((out["flow_fwd"] + out["flow_fwd_pred_bwd"]) ** 2, -1) + \
        torch.sum((out["flow_bwd"] + out["flow_bwd_pred_fwd"]) ** 2, -1)
    if mask is not None:
        mask = mask.to(c.dtype)
        return torch.sum(c * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(c)
