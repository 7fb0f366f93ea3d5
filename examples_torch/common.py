"""What the port's example trainers share: the device, the training loop
with its lifecycle gating, the checkpoint of a run, and the check that a
run resumes from a checkpoint exactly.

Randomness: the JAX scripts split `jax.random` keys; a trainer here draws
its rays and its queries' uniforms from one `torch.Generator` on the
model's device, seeded with the JAX script's integer seed (0), whose
state goes into the run's checkpoint, and the lifecycle hook of step `it`
from a generator seeded with the JAX script's `7000 + it` (or `5000 +
it`). `SEED_SHIFT` (0) is added to every one of these seeds and to the
model's initialisation seed: `tools/shift_seeds.py` sets it to run a
trainer at another seed.
"""

from __future__ import annotations

import os
import tempfile
import time
from typing import Callable, Dict, List, Optional

import torch

from nr3d_lib_tpu_torch.checkpoint import CheckpointIO
from nr3d_lib_tpu_torch.device import resolve_device
from nr3d_lib_tpu_torch.models.utils import clip_by_global_norm_
from nr3d_lib_tpu_torch.profile import profile

__all__ = ["SEED_SHIFT", "device_of", "default_out", "generator",
           "Trainer", "resume_losses"]

SEED_SHIFT = 0


def device_of(args) -> torch.device:
    """`--cpu` → the CPU; otherwise the card (raises when there is none)."""
    return torch.device("cpu") if args.cpu else resolve_device(None)


def default_out(name: str) -> str:
    """The JAX script's default output directory, under $TMPDIR."""
    return os.path.join(tempfile.gettempdir(), name)


def generator(device, seed: int) -> torch.Generator:
    return torch.Generator(device).manual_seed(seed + SEED_SHIFT)


class Trainer:
    """One example's training state and step.

    `sample(n, gen)` → a batch dict (`o`, `d`, the target `rgb`, and `ts`
    or `bidx` where the scene has them); `loss_fn(model, batch, gen)` →
    (loss, rgb loss or None). A step: the lifecycle hook (every
    `lifecycle_update_every` steps, every step when the model has a
    stepwise schedule; none when `lifecycle_seed` is False), the loss,
    backward, the gradients clipped to a global norm of `clip` (as
    `optax.clip_by_global_norm`), Adam(lr)."""

    def __init__(self, model, loss_fn: Callable, sample: Callable, *,
                 lr: float, rays: int, clip: Optional[float] = None,
                 lifecycle_seed=None):
        self.model, self.loss_fn, self.sample = model, loss_fn, sample
        self.rays, self.clip = rays, clip
        self.lifecycle_seed = lifecycle_seed
        self.opt = torch.optim.Adam(model.parameters(), lr=lr)
        self.gen = generator(model.device, 0)
        self.lifecycle_every = 1 if model.has_stepwise_schedules() \
            else model.lifecycle_update_every

    # the generator's state is part of a run's checkpoint
    def state_dict(self) -> Dict:
        return {"generator": self.gen.get_state()}

    def load_state_dict(self, sd: Dict) -> None:
        self.gen.set_state(sd["generator"])

    def checkpoint_io(self, ckpt_dir: str) -> CheckpointIO:
        ckpt = CheckpointIO(ckpt_dir)
        ckpt.register_modules(model=self.model, optimizer=self.opt,
                              trainer=self)
        return ckpt

    def step(self, it: int):
        """Train step `it`; returns (loss, rgb loss), detached, unsynced.
        Its spans: `step` (unit `it`) around `step.lifecycle` (where the
        hook runs), `step.sample`, `step.forward` (the loss function),
        `step.backward`, `step.clip` and `step.optimizer`."""
        with profile("step", unit=it):
            if self.lifecycle_seed is not False and \
                    it % self.lifecycle_every == 0:
                with profile("step.lifecycle"):
                    g = None if self.lifecycle_seed is None else \
                        generator(self.model.device, self.lifecycle_seed + it)
                    self.model.training_before_per_step(it, g)
            with profile("step.sample"):
                batch = self.sample(self.rays, self.gen)
            self.opt.zero_grad(set_to_none=True)
            with profile("step.forward"):
                loss, rgb_l = self.loss_fn(self.model, batch, self.gen)
            with profile("step.backward"):
                loss.backward()
            if self.clip is not None:
                with profile("step.clip"):
                    clip_by_global_norm_(self.model.parameters(), self.clip)
            with profile("step.optimizer"):
                self.opt.step()
            return loss.detach(), (loss if rgb_l is None else rgb_l).detach()

    def train(self, iters: int, logger, log_rgb: bool = True,
              on_step: Optional[Callable[[int], None]] = None) -> Dict:
        """Steps 0..iters-1, printing and logging the loss every 100 steps
        and at the last, as the JAX scripts do. Returns every step's loss,
        the wall seconds, and ms per step after the first five."""
        dev = self.model.device
        sync = torch.cuda.synchronize if dev.type == "cuda" else \
            (lambda: None)
        losses: List[torch.Tensor] = []
        n_warm = min(5, max(iters - 1, 0))
        t0 = t_warm = time.time()
        for it in range(iters):
            if it == n_warm:
                sync()
                t_warm = time.time()
            loss, rgb_l = self.step(it)
            losses.append(loss)
            if it % 100 == 0 or it == iters - 1:
                logger.add("train", "loss", loss, it)
                tail = f"  rgb {float(rgb_l):.5f}" if log_rgb else ""
                print(f"it {it:5d}  loss {float(loss):.5f}{tail}")
            if on_step is not None:
                on_step(it)
        sync()
        t1 = time.time()
        ms = (t1 - t_warm) / max(iters - n_warm, 1) * 1e3
        print(f"trained {iters} iters in {t1 - t0:.1f}s ({ms:.1f} ms/iter "
              f"after the first {n_warm})")
        return {"losses": torch.stack(losses).tolist() if losses else [],
                "train_s": t1 - t0, "ms_per_iter": ms}


def resume_losses(setup: Callable[[], Trainer], k: int, ckpt_dir: str,
                  n: int = 2):
    """Steps 0..k-1 of a run, a checkpoint (model, optimizer, generator),
    steps k..k+n-1; then a new run from `setup()` that loads the
    checkpoint and takes steps k..k+n-1 again. Returns both runs' losses
    of those n steps."""
    tr = setup()
    for it in range(k):
        tr.step(it)
    tr.checkpoint_io(ckpt_dir).save("resume.pt", it=k)
    straight = [float(tr.step(it)[0]) for it in range(k, k + n)]
    del tr
    tr = setup()
    extras = tr.checkpoint_io(ckpt_dir).load("resume.pt")
    resumed = [float(tr.step(it)[0])
               for it in range(extras["it"], extras["it"] + n)]
    return straight, resumed
