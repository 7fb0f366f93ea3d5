"""SDF fields (port of nr3d_lib_tpu/models/fields/sdf.py `LoTDSDF`, on
the classic and brick backends, `PermutoSDF`, classic and cell lattices,
`MlpSDF` and `pretrain_sdf_sphere`)."""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn
from torch.func import vjp

from nr3d_lib_tpu_torch.device import resolve_device
from nr3d_lib_tpu_torch.models.blocks import MLP
from nr3d_lib_tpu_torch.models.embedders import get_embedder
from nr3d_lib_tpu_torch.models.grid_encodings.lotd import get_lotd_encoding
from nr3d_lib_tpu_torch.models.grid_encodings.permuto import PermutoParams

__all__ = ["LoTDSDF", "PermutoSDF", "MlpSDF", "pretrain_sdf_sphere",
           "autograd_nablas", "SphereResidualDecoder", "DEFAULT_LOTD_CFG"]


def autograd_nablas(fn: Callable[[torch.Tensor], Tuple[torch.Tensor,
                                                       torch.Tensor]],
                    x: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(sdf, h, ∂sdf/∂x) of `fn(x) → (sdf, h)` by one autograd pass, the
    JAX package's generic nablas (`jax.vjp` of the field). With gradients
    on, the nablas keep their graph (`create_graph`), so an eikonal loss
    differentiates through them to second order; under `no_grad` the
    pass runs inside `enable_grad` and everything comes back detached."""
    graph = torch.is_grad_enabled()
    with torch.enable_grad():
        xr = x if (graph and x.requires_grad) else \
            x.detach().requires_grad_(True)
        sdf, h = fn(xr)
        (nablas,) = torch.autograd.grad(sdf, xr, torch.ones_like(sdf),
                                        create_graph=graph)
    if not graph:
        sdf, h = sdf.detach(), h.detach()
    return sdf, h, nablas


class SphereResidualDecoder(nn.Module):
    """The permutohedral concat fields' shared part (the dynamic (x, t)
    SDF, the generative [x, z] and [x, z, t] ones): the decoder over [x,
    h] with the geometric init (the sphere residual |x| − radius_init
    added to the SDF, so every instance starts as a valid surface), and
    the nablas of an encoding input built from x. The subclass owns
    `bank`."""

    def _init_decoder(self, n_enc: int, decoder_cfg: Optional[dict],
                      n_geo_feat: int, radius_init: float, seed: int,
                      device) -> None:
        self.radius_init = float(radius_init)
        dec = dict(decoder_cfg or {})
        dec.setdefault("D", 1)
        dec.setdefault("W", 64)
        self.decoder = MLP(n_enc + 3, 1 + n_geo_feat, **dec, seed=seed + 1,
                           device=device)
        self.n_geo_feat = n_geo_feat

    def _dec(self, x: torch.Tensor, h_enc: torch.Tensor):
        out = self.decoder(torch.cat([x, h_enc], -1))
        sdf = out[..., 0]
        if self.radius_init > 0:
            sdf = sdf + (torch.linalg.norm(x, dim=-1) - self.radius_init)
        return sdf, out[..., 1:]

    def _sdf_nablas(self, x: torch.Tensor, inp_of) -> Dict[str, torch.Tensor]:
        """(sdf, h, ∂sdf/∂x) with the encoding input `inp_of(x)`. The
        classic lattice: autograd through the whole field in x (JAX's
        generic `jax.vjp` branch). The cell layout: the decoder term by
        `torch.func.vjp`, the encoding term by the bank's nablas (B13),
        whose first 3 lattice-input gradients are the spatial ones, times
        0.5 for x → x·0.5 + 0.5 (JAX's cell branch; B13 or B16 on the
        card)."""
        if self.bank.backend != "cell":
            sdf, h, nablas = autograd_nablas(
                lambda xx: self._dec(xx, self.bank(inp_of(xx))), x)
            return {"sdf": sdf, "h": h, "nablas": nablas}
        inp = inp_of(x)
        h_enc = self.bank(inp)
        (sdf, h), dec_vjp = vjp(self._dec, x, h_enc)
        gx, gh = dec_vjp((torch.ones_like(sdf), torch.zeros_like(h)))
        nablas = gx + 0.5 * self.bank.nablas_path(inp, gh)[..., :3]
        return {"sdf": sdf, "h": h, "nablas": nablas}


# the JAX fields' default encoding (fields/sdf.py:37-42, nerf.py:147-151)
DEFAULT_LOTD_CFG = {"lod_res": [16, 32, 64, 128], "lod_n_feats": 2,
                    "lod_types": ["Dense", "Dense", "Hash", "Hash"],
                    "hashmap_size": 2 ** 15}


class LoTDSDF(nn.Module):
    """LoTD encoding + small decoder → (sdf, geometry feature). The
    encoding is the classic LoTD unless `encoding_cfg` asks for the brick
    backend."""

    def __init__(self, *, encoding_cfg: Optional[dict] = None,
                 decoder_cfg: Optional[dict] = None, n_geo_feat: int = 15,
                 seed: int = 0, device=None):
        super().__init__()
        enc_cfg = dict(encoding_cfg or {})
        enc_cfg.setdefault("lotd_cfg", DEFAULT_LOTD_CFG)
        self.encoding = get_lotd_encoding(3, **enc_cfg, seed=seed,
                                          device=device)
        self._enc_is_brick = enc_cfg.get("backend", "xla") == "brick"
        dec_cfg = dict(decoder_cfg or {})
        dec_cfg.setdefault("D", 1)
        dec_cfg.setdefault("W", 64)
        dec_cfg.setdefault("activation", "relu")
        self.decoder = MLP(self.encoding.out_features + 3, 1 + n_geo_feat,
                           **dec_cfg, seed=seed + 1, device=device)
        self.n_geo_feat = n_geo_feat

    def _dec(self, x: torch.Tensor, h_enc: torch.Tensor):
        out = self.decoder(torch.cat([x, h_enc], -1))
        return out[..., 0], out[..., 1:]

    def forward_sdf(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """x in [-1,1] → {sdf, h}; the decoder also sees raw x."""
        sdf, h = self._dec(x, self.encoding(x))
        return {"sdf": sdf, "h": h}

    def forward_sdf_nablas(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """(sdf, h, nablas=∂sdf/∂x). The classic encoding: by autograd
        through the whole field (`autograd_nablas`, JAX's generic
        `jax.vjp` branch). The brick backend: split as in the JAX brick
        path, nablas = ∂sdf/∂x_direct + J_encᵀ·∂sdf/∂h_enc, the decoder
        term by `torch.func.vjp` (works under `no_grad`; under outer
        autograd its outputs stay differentiable, so an eikonal loss
        reaches the decoder weights), the encoding term by the encoding's
        nablas kernel (B8 for F=2, B3 for F=4; their backwards are B9 and
        B4)."""
        if not self._enc_is_brick:
            sdf, h, nablas = autograd_nablas(
                lambda xx: self._dec(xx, self.encoding(xx)), x)
            return {"sdf": sdf, "h": h, "nablas": nablas}
        batch = x.shape[:-1]
        xf = x.reshape(-1, 3)
        h_enc = self.encoding(xf)
        (sdf, h), dec_vjp = vjp(self._dec, xf, h_enc)
        gx, gh = dec_vjp((torch.ones_like(sdf), torch.zeros_like(h)))
        nablas = gx + self.encoding.nablas_path(xf, gh)
        return {"sdf": sdf.reshape(batch),
                "h": h.reshape(*batch, h.shape[-1]),
                "nablas": nablas.reshape(*batch, 3)}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.forward_sdf(x)["sdf"]


class PermutoSDF(nn.Module):
    """Static permutohedral-encoded SDF: a 3D permuto table (the classic
    lattice by default, or the cell layout), a small decoder over [x,
    features], and an optional sphere residual (|x| − radius_init added
    to the sdf)."""

    def __init__(self, *, permuto_cfg: Optional[dict] = None,
                 decoder_cfg: Optional[dict] = None, n_geo_feat: int = 15,
                 radius_init: float = 0.0, seed: int = 0, device=None):
        super().__init__()
        cfg = dict(permuto_cfg or {})
        cfg.setdefault("res_list", [8.0, 16.0, 32.0, 64.0, 128.0])
        cfg.setdefault("n_feats", 2)
        cfg.setdefault("log2_hashmap_size", 17)
        self.bank = PermutoParams(
            3, cfg["res_list"], n_feats=cfg["n_feats"],
            log2_hashmap_size=cfg["log2_hashmap_size"],
            backend=cfg.get("backend", "xla"),
            hashmap_rows=cfg.get("hashmap_rows", 4096), seed=seed,
            device=device)
        self.meta = self.bank.meta
        dec_cfg = dict(decoder_cfg or {})
        dec_cfg.setdefault("D", 1)
        dec_cfg.setdefault("W", 64)
        self.decoder = MLP(self.bank.out_features + 3, 1 + n_geo_feat,
                           **dec_cfg, seed=seed + 1, device=device)
        self.n_geo_feat = n_geo_feat
        self.radius_init = float(radius_init)

    def _dec(self, x: torch.Tensor, h_enc: torch.Tensor):
        out = self.decoder(torch.cat([x, h_enc], -1))
        sdf = out[..., 0]
        if self.radius_init > 0:
            sdf = sdf + (torch.linalg.norm(x, dim=-1) - self.radius_init)
        return sdf, out[..., 1:]

    def forward_sdf(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """x in [-1,1] → {sdf, h}; the lattice sees x·0.5 + 0.5."""
        sdf, h = self._dec(x, self.bank(x * 0.5 + 0.5))
        return {"sdf": sdf, "h": h}

    def forward_sdf_nablas(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """(sdf, h, nablas=∂sdf/∂x). The classic lattice: by autograd
        through the whole field (`autograd_nablas`, JAX's generic branch).
        The cell layout: split as in the JAX cell path, the decoder term
        by `torch.func.vjp`, the encoding term by the bank's nablas (B13
        for F=2, B16 for F=4), times 0.5 for x → x·0.5+0.5."""
        if self.bank.backend != "cell":
            sdf, h, nablas = autograd_nablas(
                lambda xx: self._dec(xx, self.bank(xx * 0.5 + 0.5)),
                x)
            return {"sdf": sdf, "h": h, "nablas": nablas}
        batch = x.shape[:-1]
        xf = x.reshape(-1, 3)
        x01 = xf * 0.5 + 0.5
        h_enc = self.bank(x01)
        (sdf, h), dec_vjp = vjp(self._dec, xf, h_enc)
        gx, gh = dec_vjp((torch.ones_like(sdf), torch.zeros_like(h)))
        nablas = gx + 0.5 * self.bank.nablas_path(x01, gh)
        return {"sdf": sdf.reshape(batch),
                "h": h.reshape(*batch, h.shape[-1]),
                "nablas": nablas.reshape(*batch, 3)}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.forward_sdf(x)["sdf"]


class MlpSDF(nn.Module):
    """Geometric-init MLP SDF: an embedded input (identity by default)
    through an MLP (D layers of W, a skip, softplus β = 100) whose init
    makes sdf ≈ |x| − radius_init. `device=None` means CUDA (raises
    without a card); tests pass `device="cpu"`."""

    def __init__(self, *, pos_embed_cfg: Optional[dict] = None,
                 D: int = 8, W: int = 256, skips=(4,),
                 n_geo_feat: int = 15, radius_init: float = 0.5,
                 seed: int = 0, device=None):
        super().__init__()
        device = resolve_device(device)
        self.embed_fn, pos_dim = get_embedder(
            pos_embed_cfg or {"type": "identity"}, 3)
        self.mlp = MLP(pos_dim, 1 + n_geo_feat, D=D, W=W, skips=skips,
                       activation="softplus", geometric_init=True,
                       radius_init=radius_init, seed=seed, device=device)
        self.n_geo_feat = n_geo_feat

    def _sdf_h(self, x: torch.Tensor):
        out = self.mlp(self.embed_fn(x))
        return out[..., 0], out[..., 1:]

    def forward_sdf(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        sdf, h = self._sdf_h(x)
        return {"sdf": sdf, "h": h}

    def forward_sdf_nablas(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """(sdf, h, nablas=∂sdf/∂x) by autograd through the MLP, second
        order under gradients (`autograd_nablas`). The JAX method raises
        here (its generic branch passes `ho=` to an `_sdf_h` without
        it); this is the `jax.vjp` of its `forward_sdf`."""
        sdf, h, nablas = autograd_nablas(self._sdf_h, x)
        return {"sdf": sdf, "h": h, "nablas": nablas}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._sdf_h(x)[0]


def pretrain_sdf_sphere(model: nn.Module,
                        generator: Optional[torch.Generator] = None, *,
                        radius: float = 0.5, n_iters: int = 500,
                        n_pts: int = 2048, lr: float = 1e-3,
                        draw=None) -> float:
    """Fit the SDF `model` (x → sdf) to the sphere |x| − radius before
    scene training: Adam(lr) on the mean squared error at one draw of
    [n_pts, 3] uniform points in [−1, 1]³ a step. `draw` (a
    `graphics.raysample.Draw`) hands in the points' uniforms, as the
    tests hand in the JAX package's; otherwise `generator` (or a
    generator seeded with 0) draws them on the model's device. Returns
    the last step's loss."""
    from nr3d_lib_tpu_torch.graphics.raysample import uniform_draw

    if draw is None:
        dev = next(model.parameters()).device
        draw = uniform_draw(generator if generator is not None else
                            torch.Generator(dev).manual_seed(0))
    opt = torch.optim.Adam(model.parameters(), lr=lr)
    loss = torch.tensor(float("inf"))
    for _ in range(n_iters):
        x = draw((n_pts, 3), -1.0, 1.0)
        target = torch.linalg.norm(x, dim=-1) - radius
        opt.zero_grad(set_to_none=True)
        loss = torch.mean((model(x) - target) ** 2)
        loss.backward()
        opt.step()
    return float(loss.detach())
