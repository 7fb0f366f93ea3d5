"""Plain PyTorch pieces the references share: weights from a seed, the
MLPs, the direction encoding, rays, the ray-box test, the occupancy grid
and its march, budget compaction, volume weights, inverse-CDF sampling,
and a clipped Adam step.

Each follows the published description of the method (NeuS, Instant-NGP,
NeRF) as nr3d_lib states it; the numbers it takes come from the
configuration file. Nothing here imports the program under test.
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch

CDF_EPS = 1e-8
BIG_SDF = 1e4


def derived_seed(seed: int, purpose: str) -> int:
    """A 60-bit seed for one purpose, drawn from the run's seed."""
    h = hashlib.sha256(f"{int(seed)}:{purpose}".encode()).hexdigest()
    return int(h[:15], 16)


def generator(device, seed: int, purpose: str) -> torch.Generator:
    return torch.Generator(device).manual_seed(derived_seed(seed, purpose))


# ------------------------------------------------------------------ weights
def mlp_shapes(n_in: int, n_out: int, D: int, W: int) -> List[Tuple[int, int]]:
    dims = [n_in] + [W] * D + [n_out]
    return [(dims[i], dims[i + 1]) for i in range(len(dims) - 1)]


def fill_mlp(out: Dict[str, torch.Tensor], prefix: str, shapes, normal,
             geometric: Optional[dict] = None) -> None:
    """Weights [in, out] and biases of one MLP from the standard normals
    `normal` (consumed in order). Truncated normal of std 1/√in and zero
    bias; with `geometric` the SDF sphere init for a ReLU net (the first
    layer's xyz rows N(0, 2/out), its other rows N(0, enc_std²); the last
    layer √π/√in + 1e-4·N(0, 1), bias −radius), so the net starts as
    |x| − radius plus what the encoding adds."""
    for i, (n_in, n_out) in enumerate(shapes):
        z = normal(n_in * n_out).reshape(n_in, n_out)
        b = torch.zeros(n_out, device=z.device)
        if geometric is None:
            w = z.clamp(-2.0, 2.0) / math.sqrt(n_in)
        elif i == len(shapes) - 1:
            w = math.sqrt(math.pi) / math.sqrt(n_in) + 1e-4 * z
            b = b - float(geometric["radius"])
        else:
            w = z * math.sqrt(2.0) / math.sqrt(n_out)
            if i == 0:
                w = torch.cat([w[:3], z[3:] * float(geometric["enc_std"])])
        out[f"{prefix}.ws.{i}"] = w.contiguous()
        out[f"{prefix}.bs.{i}"] = b


class Draws:
    """One large draw of uniforms and one of normals, handed out in
    pieces: weights come from a few large calls on the device."""

    def __init__(self, gen: torch.Generator, n_uniform: int, n_normal: int):
        dev = gen.device
        self.u = torch.rand(n_uniform, generator=gen, device=dev)
        self.z = torch.randn(n_normal, generator=gen, device=dev)
        self.iu = self.iz = 0

    def uniform(self, n: int) -> torch.Tensor:
        self.iu += n
        return self.u[self.iu - n:self.iu]

    def normal(self, n: int) -> torch.Tensor:
        self.iz += n
        return self.z[self.iz - n:self.iz]


# ---------------------------------------------------------------- networks
def mlp(x: torch.Tensor, w: Dict[str, torch.Tensor], prefix: str,
        n_layers: int, out_act=None, dtype=torch.float32) -> torch.Tensor:
    """ReLU MLP h @ w + b; `dtype` is the precision of the products."""
    h = x.to(dtype)
    for i in range(n_layers):
        h = h @ w[f"{prefix}.ws.{i}"].to(dtype) + w[f"{prefix}.bs.{i}"].to(
            dtype)
        if i < n_layers - 1:
            h = torch.relu(h)
    h = h.to(torch.float32)
    return h if out_act is None else out_act(h)


def sh4(d: torch.Tensor) -> torch.Tensor:
    """Real spherical harmonics of degree 4 (16 terms, Instant-NGP's
    order) of unit directions."""
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    xy, yz, xz = x * y, y * z, x * z
    x2, y2, z2 = x * x, y * y, z * z
    return torch.stack([
        torch.full_like(x, 0.28209479177387814),
        -0.48860251190291987 * y, 0.48860251190291987 * z,
        -0.48860251190291987 * x,
        1.0925484305920792 * xy, -1.0925484305920792 * yz,
        0.94617469575755997 * z2 - 0.31539156525251999,
        -1.0925484305920792 * xz, 0.54627421529603959 * (x2 - y2),
        0.59004358992664352 * y * (-3.0 * x2 + y2),
        2.8906114426405538 * xy * z,
        0.45704579946446572 * y * (1.0 - 5.0 * z2),
        0.3731763325901154 * z * (5.0 * z2 - 3.0),
        0.45704579946446572 * x * (1.0 - 5.0 * z2),
        1.4453057213202769 * z * (x2 - y2),
        0.59004358992664352 * x * (-x2 + 3.0 * y2)], -1)


# -------------------------------------------------------------------- rays
def pinhole_rays(c2w: torch.Tensor, hw: Sequence[int], focal: float
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every pixel's world ray (centre of the pixel, OpenCV camera: x
    right, y down, z forward), rows first → (o [..., HW, 3], d); c2w
    [4, 4], or [B, 1, 4, 4] for B cameras."""
    h, w = hw
    dev = c2w.device
    ys, xs = torch.meshgrid(torch.arange(h, device=dev) + 0.5,
                            torch.arange(w, device=dev) + 0.5, indexing="ij")
    return rays_from_pixels(c2w, xs.reshape(-1), ys.reshape(-1), hw, focal)


def rays_from_pixels(c2w, u, v, hw, focal):
    """Rays through pixel coordinates u (x) and v (y) of one camera (c2w
    [4, 4]) or of one camera each (c2w [N, 4, 4])."""
    h, w = hw
    dirs = torch.stack([(u - w / 2) / focal, (v - h / 2) / focal,
                        torch.ones_like(u)], -1)
    d = torch.einsum("...ij,...j->...i", c2w[..., :3, :3], dirs)
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    return torch.broadcast_to(c2w[..., :3, 3], d.shape), d


def ray_box(o: torch.Tensor, d: torch.Tensor, lo, hi):
    """Slab test against the box [lo, hi] → (near, far, hit)."""
    lo = torch.as_tensor(lo, dtype=o.dtype, device=o.device)
    hi = torch.as_tensor(hi, dtype=o.dtype, device=o.device)
    tiny = torch.where(d >= 0, 1e-12, -1e-12).to(d.dtype)
    inv = 1.0 / torch.where(d.abs() < 1e-12, tiny, d)
    t0, t1 = (lo - o) * inv, (hi - o) * inv
    near = torch.clamp(torch.minimum(t0, t1).amax(-1), min=0.0)
    far = torch.clamp(torch.maximum(t0, t1).amin(-1), max=1e10)
    hit = near < far
    zero = torch.zeros_like(near)
    return torch.where(hit, near, zero), torch.where(hit, far, zero), hit


# ---------------------------------------------------------------- the grid
def cell_centers(res: int, device) -> torch.Tensor:
    lin = (torch.arange(res, dtype=torch.float32, device=device) + 0.5) / \
        res * 2.0 - 1.0
    g = torch.stack(torch.meshgrid(lin, lin, lin, indexing="ij"), -1)
    return g.reshape(-1, 3)


def occ_lookup(occ: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Occupancy of the binary grid occ [r, r, r] at x [..., 3] in
    [−1, 1]; outside the grid nothing is occupied."""
    res = occ.shape[0]
    i = torch.floor((x + 1.0) * 0.5 * float(res)).to(torch.int64)
    inb = ((i >= 0) & (i < res)).all(-1)
    i = i.clamp(0, res - 1)
    return occ[i[..., 0], i[..., 1], i[..., 2]] & inb


def march(occ: torch.Tensor, o: torch.Tensor, d: torch.Tensor,
          near: torch.Tensor, far: torch.Tensor, n_steps: int,
          step: float, u: Optional[torch.Tensor] = None):
    """Fixed steps from near, sampled at the step's midpoint (or at its
    start + u·step), kept where inside [near, far) and in an occupied
    cell → (t [R, S], dt [R, S], mask [R, S])."""
    r = near.shape[0]
    dt = torch.full((n_steps,), step, dtype=near.dtype, device=near.device)
    t_end = torch.cumsum(dt.to(torch.float64), 0).to(near.dtype)
    t0 = (t_end - dt)[None, :] + near[:, None]
    dt = dt[None, :].expand(r, n_steps)
    t = t0 + (0.5 if u is None else u) * dt
    inr = (t < far[:, None]) & (t0 >= near[:, None] - 1e-9)
    x = o[:, None, :] + d[:, None, :] * t[..., None]
    return t, dt, inr & occ_lookup(occ, x)


def budgeted(arrays: Sequence[torch.Tensor], mask: torch.Tensor,
             budget: int):
    """Each row's first `budget` masked entries, in order → ([R, B, ...]
    each, valid [R, B]); empty slots hold 0."""
    rank = torch.cumsum(mask.to(torch.int64), -1)
    keep = mask & (rank <= budget)
    slot = torch.where(keep, rank - 1, torch.full_like(rank, budget))
    valid = rank[:, -1:] >= torch.arange(1, budget + 1,
                                         device=mask.device)[None]
    outs = []
    for a in arrays:
        idx = slot.reshape(slot.shape + (1,) * (a.dim() - 2)).expand_as(a)
        o = torch.zeros((a.shape[0], budget + 1) + tuple(a.shape[2:]),
                        dtype=a.dtype, device=a.device)
        outs.append(o.scatter(1, idx, a)[:, :budget])
    return outs, valid


def vis_weights(alpha: torch.Tensor) -> torch.Tensor:
    """α [..., S] → α · exclusive transmittance."""
    one_m = torch.clamp(1.0 - alpha, 0.0, 1.0)
    trans = torch.cumprod(torch.cat([torch.ones_like(one_m[..., :1]),
                                     one_m[..., :-1]], -1).double(),
                          -1).to(alpha.dtype)
    return alpha * trans


def sample_pdf(bins: torch.Tensor, weights: torch.Tensor, n: int,
               u: Optional[torch.Tensor]) -> torch.Tensor:
    """Inverse-CDF samples of per-bin weights (+1e-5) over the edges
    `bins` [R, B+1]; `u` [R, n] the quantiles, None: (i + ½)/n."""
    w = weights + 1e-5
    pdf = w / torch.sum(w, -1, keepdim=True)
    cdf = torch.cat([torch.zeros_like(pdf[..., :1]),
                     torch.cumsum(pdf.double(), -1).to(pdf.dtype)], -1)
    r, nb = bins.shape
    if u is None:
        u = torch.linspace(0.5 / n, 1.0 - 0.5 / n, n, device=bins.device)
        u = u.expand(r, n)
    u = u.contiguous()
    hi = torch.searchsorted(cdf.contiguous(), u, right=True).clamp(1, nb - 1)
    lo = hi - 1
    c0, c1 = cdf.gather(-1, lo), cdf.gather(-1, hi)
    b0, b1 = bins.gather(-1, lo), bins.gather(-1, hi)
    den = torch.where(c1 - c0 < CDF_EPS, torch.ones_like(c0), c1 - c0)
    return b0 + torch.clamp((u - c0) / den, 0.0, 1.0) * (b1 - b0)


def uniform_draw(gen: Optional[torch.Generator]):
    """U[lo, hi) of a shape from `gen`; None when `gen` is None."""
    if gen is None:
        return None

    def draw(shape, lo=0.0, hi=1.0):
        return lo + (hi - lo) * torch.rand(shape, generator=gen,
                                           device=gen.device)
    return draw


# ----------------------------------------------------------------- Adam
class Adam:
    """Adam (β 0.9, 0.999, ε 1e-8) after clipping the gradients to a
    global norm (unchanged below it, else g / norm · max_norm)."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float,
                 clip: Optional[float], state: Optional[dict] = None):
        """`state`: the moments {"m", "v"} by name and the step count
        "t" to start from (else zeros and 0)."""
        self.p, self.lr, self.clip = params, lr, clip
        if state is None:
            self.m = {k: torch.zeros_like(v) for k, v in params.items()}
            self.v = {k: torch.zeros_like(v) for k, v in params.items()}
            self.t = 0
        else:
            self.m = {k: state["m"][k].detach().clone() for k in params}
            self.v = {k: state["v"][k].detach().clone() for k in params}
            self.t = int(state["t"])

    def step(self, grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Applies one step; returns the gradients as the step took them."""
        if self.clip is not None:
            norm = torch.sqrt(sum(torch.sum(g.double() ** 2)
                                  for g in grads.values())).float()
            grads = {k: torch.where(norm < self.clip, g, g / norm * self.clip)
                     for k, g in grads.items()}
        self.t += 1
        b1, b2 = 0.9, 0.999
        with torch.no_grad():
            for k, g in grads.items():
                self.m[k].mul_(b1).add_(g, alpha=1 - b1)
                self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                m_hat = self.m[k] / (1 - b1 ** self.t)
                v_hat = self.v[k] / (1 - b2 ** self.t)
                self.p[k].sub_(self.lr * m_hat / (v_hat.sqrt() + 1e-8))
        return grads
