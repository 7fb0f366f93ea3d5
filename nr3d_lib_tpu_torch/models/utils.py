"""Training utilities (port of nr3d_lib_tpu/models/utils.py:
`get_scheduler`, `get_optimizer`, `batchify_query`, `calc_grad_norm` and
`clip_grad_norm`), and the global-norm clip of the JAX package's
trainers, `optax.clip_by_global_norm`, on torch gradients.

The JAX package's optimizers are optax transformations; here
`get_optimizer` returns a `torch.optim.Optimizer` over the given
parameters whose steps equal optax's: the same defaults (Adam with
b2 = 0.99 and eps = 1e-15; optax's AdamW, SGD with momentum and RMSprop
defaults), the learning rate of step k (0, 1, ...) read from the
schedule at k, as optax counts, and the optional global-norm clip before
the update. `torch.optim.RMSprop` is not `optax.rmsprop` (decay 0.99
against 0.9, eps outside the root against inside), so RMSprop is written
out here.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, Mapping, Optional, Sequence, Union

import torch

__all__ = ["get_optimizer", "get_scheduler", "batchify_query",
           "calc_grad_norm", "clip_grad_norm", "clip_by_global_norm_"]

Schedule = Callable[[int], float]


def get_scheduler(type: str = "constant", lr: float = 5e-4,
                  **kwargs) -> Schedule:
    """A schedule step → learning rate, the optax schedule of the same
    name and arguments: constant; multistep (× gamma from each milestone
    on); exponential (lr · min_factor^(step/num_iters)); warmup_cosine
    (linear from 0 over warmup_steps, then cosine to lr · min_factor at
    num_iters; 0 at step 0); plenoxels (log-linear from lr to lr_final,
    with an optional sine ramp over delay_steps). An unknown type raises
    ValueError."""
    t = type.lower()
    if t in ("constant", "none"):
        return lambda step: float(lr)
    if t in ("multistep", "multi_step"):
        gamma = float(kwargs.get("gamma", 0.1))
        milestones = sorted({int(m) for m in kwargs.get("milestones", [])})

        def multistep(step):
            v = float(lr)
            for m in milestones:
                if step >= m:
                    v *= gamma
            return v
        return multistep
    if t in ("exponential", "exp"):
        total = kwargs.get("num_iters", kwargs.get("total_steps", 100000))
        rate = float(kwargs.get("min_factor", 0.1))
        if total <= 0 or rate == 0:
            return lambda step: float(lr)
        return lambda step: float(lr) if step <= 0 else \
            lr * rate ** (step / total)
    if t in ("warmup_cosine", "warmupcosine", "cosine"):
        warmup = int(kwargs.get("warmup_steps", kwargs.get("warmup", 500)))
        total = kwargs.get("num_iters", kwargs.get("total_steps", 100000))
        end = lr * kwargs.get("min_factor", 0.05)
        alpha = 0.0 if lr == 0 else end / lr
        decay = total - warmup
        if not decay > 0:
            raise ValueError(f"warmup_cosine needs num_iters > warmup_steps, "
                             f"got {total} and {warmup}")

        def warmup_cosine(step):
            if step < warmup:
                frac = 1.0 - min(max(step, 0), warmup) / warmup
                return -lr * frac + lr
            c = min(step - warmup, decay)
            cos = 0.5 * (1.0 + math.cos(math.pi * c / decay))
            return lr * ((1.0 - alpha) * cos + alpha)
        return warmup_cosine
    if t in ("plenoxels", "exponential_step"):
        total = kwargs.get("num_iters", 100000)
        final = kwargs.get("lr_final", lr * 0.01)
        delay_steps = kwargs.get("delay_steps", 0)
        delay_mult = kwargs.get("delay_mult", 1.0)

        def plenoxels(step):
            s = min(max(step / total, 0.0), 1.0)
            base = math.exp(math.log(lr) * (1 - s) + math.log(final) * s)
            delay = 1.0
            if delay_steps > 0:
                delay = delay_mult + (1 - delay_mult) * math.sin(
                    0.5 * math.pi * min(max(step / delay_steps, 0.0), 1.0))
            return delay * base
        return plenoxels
    raise ValueError(f"Unknown scheduler: {type}")


class _OptaxRMSprop(torch.optim.Optimizer):
    """optax.rmsprop at its defaults (the JAX package's): ν ← decay·ν +
    (1 − decay)·g² from ν₀ = 0, then p ← p − lr · g / √(ν + eps), with
    decay 0.9 and eps 1e-8."""

    def __init__(self, params, lr: float):
        super().__init__(params, dict(lr=lr, decay=0.9, eps=1e-8))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["nu"] = torch.zeros_like(p)
                nu = state["nu"]
                nu.mul_(group["decay"]).addcmul_(p.grad, p.grad,
                                                 value=1 - group["decay"])
                p.add_(p.grad * torch.rsqrt(nu + group["eps"]),
                       alpha=-group["lr"])
        return loss


class _Scheduled:
    """An optimizer whose step k (counted in each parameter group's
    "schedule_step", so the count travels with `state_dict`) runs at the
    schedule's rate at k, after clipping the gradients' global norm to
    `clip` (if set)."""

    def __init__(self, params, schedule: Schedule,
                 clip: Optional[float] = None, **kwargs):
        super().__init__(params, lr=float(schedule(0)), **kwargs)
        self.schedule = schedule
        self.clip = clip
        for group in self.param_groups:
            group.setdefault("schedule_step", 0)

    def step(self, closure=None):
        for group in self.param_groups:
            group["lr"] = float(self.schedule(group["schedule_step"]))
        if self.clip:
            clip_by_global_norm_([p for g in self.param_groups
                                  for p in g["params"]], self.clip)
        loss = super().step(closure)
        for group in self.param_groups:
            group["schedule_step"] += 1
        return loss


class ScheduledAdam(_Scheduled, torch.optim.Adam):
    pass


class ScheduledAdamW(_Scheduled, torch.optim.AdamW):
    pass


class ScheduledSGD(_Scheduled, torch.optim.SGD):
    pass


class ScheduledRMSprop(_Scheduled, _OptaxRMSprop):
    pass


def get_optimizer(params: Iterable[torch.Tensor], type: str = "adam",
                  lr: float = 5e-4, scheduler_cfg: Optional[dict] = None,
                  **kwargs) -> torch.optim.Optimizer:
    """A torch optimizer over `params` whose steps equal the JAX package's
    optax optimizer of the same arguments: adam (beta1 0.9, beta2 0.99,
    eps 1e-15 unless given), adamw (optax's b2 0.999, eps 1e-8,
    weight_decay 1e-2 unless given), sgd (momentum 0.9 unless given),
    rmsprop (optax's decay 0.9, eps 1e-8 inside the root); the rate from
    `get_scheduler(lr=lr, **scheduler_cfg)` (constant by default);
    `clip_grad_norm=c` clips the gradients' global norm to c before each
    update, as `optax.clip_by_global_norm`. Unlike optax's, the
    optimizer takes the parameters. An unknown type raises ValueError."""
    sched = get_scheduler(lr=lr, **(scheduler_cfg or {"type": "constant"}))
    clip = kwargs.get("clip_grad_norm")
    t = type.lower()
    if t == "adam":
        return ScheduledAdam(params, sched, clip,
                             betas=(kwargs.get("beta1", 0.9),
                                    kwargs.get("beta2", 0.99)),
                             eps=kwargs.get("eps", 1e-15))
    if t == "adamw":
        return ScheduledAdamW(params, sched, clip, betas=(0.9, 0.999),
                              eps=1e-8,
                              weight_decay=kwargs.get("weight_decay", 1e-2))
    if t == "sgd":
        return ScheduledSGD(params, sched, clip,
                            momentum=kwargs.get("momentum", 0.9))
    if t == "rmsprop":
        return ScheduledRMSprop(params, sched, clip)
    raise ValueError(f"Unknown optimizer: {type}")


def batchify_query(fn: Callable, *arrays: torch.Tensor, chunk: int = 2 ** 16,
                   dim: int = 0):
    """fn over chunks of `chunk` rows of each array (sliced along the
    first axis), the results concatenated along `dim`; a dict or tuple
    result is concatenated entry by entry. One call when the arrays fit
    in one chunk."""
    n = arrays[0].shape[0]
    if n <= chunk:
        return fn(*arrays)
    outs = [fn(*[a[s:s + chunk] for a in arrays]) for s in range(0, n, chunk)]
    first = outs[0]
    if isinstance(first, dict):
        return {k: torch.cat([o[k] for o in outs], dim) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(torch.cat([o[i] for o in outs], dim)
                           for i in range(len(first)))
    return torch.cat(outs, dim)


def calc_grad_norm(params: Iterable[torch.Tensor],
                   norm_type: float = 2.0) -> torch.Tensor:
    """The global norm of the parameters' gradients (those without a
    gradient skipped), a 0-d float32 tensor on their device: L2, or the
    largest |g| for norm_type inf."""
    grads = [p.grad for p in params if p.grad is not None]
    if norm_type == float("inf"):
        return torch.stack([g.abs().amax().to(torch.float32)
                            for g in grads]).amax()
    return torch.sqrt(sum(torch.sum(g.to(torch.float32) ** 2)
                          for g in grads))


def clip_grad_norm(grads: Union[Sequence[torch.Tensor],
                                Mapping[str, torch.Tensor]],
                   max_norm: float):
    """Gradients (a list, tuple or dict of tensors) scaled by
    min(1, max_norm / max(norm, 1e-12)) → (the scaled gradients in the
    same container, the global L2 norm before scaling)."""
    leaves = list(grads.values()) if isinstance(grads, Mapping) else \
        list(grads)
    norm = torch.sqrt(sum(torch.sum(g.to(torch.float32) ** 2)
                          for g in leaves))
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    if isinstance(grads, Mapping):
        return {k: g * scale for k, g in grads.items()}, norm
    return type(grads)(g * scale for g in grads), norm


@torch.no_grad()
def clip_by_global_norm_(params: Iterable[torch.Tensor],
                         max_norm: float) -> torch.Tensor:
    """Clip the gradients in place as `optax.clip_by_global_norm` does:
    unchanged while their global norm is below `max_norm`, else each
    becomes g / norm · max_norm (`torch.nn.utils.clip_grad_norm_` scales
    by max_norm / (norm + 1e-6) instead). Decided on the device, with no
    host sync. Returns the norm before clipping."""
    params = [p for p in params if p.grad is not None]
    norm = calc_grad_norm(params)
    for p in params:
        p.grad.copy_(torch.where(norm < max_norm, p.grad,
                                 p.grad / norm * max_norm))
    return norm
