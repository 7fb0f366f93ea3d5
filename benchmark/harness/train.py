"""A training cell: closed-loop steps of `examples_torch.common.Trainer`
on rays drawn from pre-rendered views, and the check of its first three
steps and of one step of the window against the plain reference.

Set-up builds one Trainer, drives it from the seed through steps 0-2
(the grid update at step 0 included) and keeps what the check compares:
each step's loss, the first gradient as Adam took it (its first moment
over 1 − β1) and the parameters after step 2. The same Trainer then runs
the window from step 3. One occupancy-update step of the window, drawn
from the seed, is replayed: its parameters, Adam state, grid and data
generator are copied on the device before it runs (no sync), its loss,
the gradient Adam took (from the first moment before and after) and the
parameters after it are kept, and the reference replays the step from
the copy."""

from __future__ import annotations

import statistics
from typing import Dict, List, Optional

import torch

from harness import program
from harness.counters import Counters
from harness.driver import Driver
from harness.scene import Scene, Views
from reference.common import derived_seed, generator

N_CHECKED = 3         # steps the reference follows from the weights
ADAM_BETA1 = 0.9      # torch.optim.Adam's default, which the Trainer uses


def norm_gap(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
             leaves: Optional[List[str]] = None) -> float:
    """The worst leaf's gap between the program's norm and the
    reference's, over the larger of the reference leaf's norm and the
    median leaf's."""
    leaves = list(ref) if leaves is None else leaves
    nr = {k: float(torch.linalg.norm(ref[k].double())) for k in ref}
    med = statistics.median(nr.values())
    return max(abs(float(torch.linalg.norm(prog[k].double())) - nr[k]) /
               max(nr[k], med, 1e-30) for k in leaves)


def compare(prog: dict, ref: dict) -> Dict[str, float]:
    """The three numbers of a training check. Leaves whose reference
    gradient is below a thousandth of the median leaf's move by
    round-off alone under Adam and are left out of the change."""
    gn = {k: float(torch.linalg.norm(v.double()))
          for k, v in ref["grad"].items()}
    med = statistics.median(gn.values())
    moving = [k for k, v in gn.items() if v >= 1e-3 * med]
    d_prog = {k: prog["params"][k] - prog["p0"][k] for k in moving}
    d_ref = {k: ref["params"][k] - ref["p0"][k] for k in moving}
    return {
        "loss_gap": max(abs(a - b) / abs(b)
                        for a, b in zip(prog["losses"], ref["losses"])),
        "grad_gap": norm_gap(prog["grad"], ref["grad"]),
        "change_gap": norm_gap(d_prog, d_ref),
    }


def replay_step(seed: int, update_every: int, choices: int) -> int:
    """The window step the check replays: one of the first `choices`
    occupancy-update steps after set-up's, drawn from the seed."""
    first = -(-N_CHECKED // update_every) * update_every
    return first + update_every * (derived_seed(seed, "replay") % choices)


class TrainCell(Driver):
    # ------------------------------------------------------------ set-up
    def setup(self) -> None:
        from examples_torch.common import Trainer

        cfg, tr = self.cell.config, self.cell.traffic
        dev, seed, recipe = self.dev, self.seed, self.cell.recipe
        ph = program.Phases(dev)
        self.weights = self.cell.reference.make_weights(
            cfg, generator(dev, seed, "weights"))
        self.model = model = program.build_model(cfg, dev)
        program.load_weights(model, self.weights)
        model.populate()
        ph.mark("model")
        if self.traced:
            self.counters = Counters(model, cfg["counted"], training=True)
        self.views = Views(Scene(cfg["scene"], dev), tr,
                           generator(dev, seed, "views"))
        ph.mark("views")
        self.lifecycle_seed = derived_seed(seed, "lifecycle")
        self.trainer = Trainer(
            model, self.loss, lambda n, g: recipe.sample(self.views, n, g),
            lr=cfg["train"]["lr"], rays=tr["rays_per_step"],
            clip=cfg["train"]["clip"], lifecycle_seed=self.lifecycle_seed)
        self.trainer.gen = generator(dev, seed, "data")
        self.replay_it = replay_step(
            seed, cfg["program"]["kwargs"]["accel_cfg"]["update_every"],
            tr["replay_updates"])
        self.before = self.after = None
        losses, grad = [], None
        for it in range(N_CHECKED):
            losses.append(self.trainer.step(it)[0])
            if it == 0:
                grad = {n: self.trainer.opt.state[p]["exp_avg"].detach() /
                        (1.0 - ADAM_BETA1)
                        for n, p in model.named_parameters()}
        self.first = {"losses": [float(x) for x in losses], "grad": grad,
                      "params": {n: p.detach().clone()
                                 for n, p in model.named_parameters()}}
        self.it = N_CHECKED
        ph.mark("first steps")
        ph.report()

    def loss(self, m, b, gen):
        return self.cell.recipe.loss(m, b, gen, self.cell.config)

    # ------------------------------------------------------------ window
    def _state(self) -> dict:
        """Copies, on the device and unsynchronised, of what a step reads
        and changes: parameters, Adam's moments and step count, the
        occupancy values, the data generator's state."""
        named = list(self.model.named_parameters())
        st = self.trainer.opt.state
        return {"params": {n: p.detach().clone() for n, p in named},
                "m": {n: st[p]["exp_avg"].clone() for n, p in named},
                "v": {n: st[p]["exp_avg_sq"].clone() for n, p in named},
                "t": int(st[named[0][1]]["step"]),
                "grid": self.model.accel.occ.val_grid.detach().clone(),
                "gen": self.trainer.gen.get_state()}

    def unit(self) -> torch.Tensor:
        """One training step; its loss, not synchronised."""
        it = self.it
        if it == self.replay_it:
            self.before = self._state()
        loss, _ = self.trainer.step(it)
        if it == self.replay_it:
            self.after = dict(self._state(), loss=loss)
        self.it += 1
        return loss

    def failed(self, out: List[torch.Tensor]) -> int:
        """Steps whose loss is not finite."""
        return int((~torch.isfinite(torch.stack(out))).sum())

    def metrics(self, out, elapsed: float) -> Dict[str, float]:
        return {"train_rays_per_s":
                len(out) * self.cell.traffic["rays_per_step"] / elapsed}

    def free_program(self) -> None:
        # a window shorter than the replayed step's (small test runs
        # only) steps on to it, after the window has closed
        while self.after is None:
            self.unit()
        b, a = self.before, self.after
        self.replayed = {
            "losses": [float(a["loss"])], "p0": b["params"],
            "params": a["params"],
            "grad": {k: (a["m"][k] - ADAM_BETA1 * b["m"][k]) /
                     (1.0 - ADAM_BETA1) for k in b["m"]}}
        self.after = None
        self.trainer = self.model = None
        self.counters = None
        program.release(self.dev)

    # ------------------------------------------------------------- check
    def _sample(self):
        n = self.cell.traffic["rays_per_step"]
        return lambda g: self.cell.recipe.sample(self.views, n, g)

    def reference(self, dtype=torch.float32) -> dict:
        """The reference's first three steps from the same weights and
        generators, with its products in `dtype`."""
        cfg, recipe = self.cell.config, self.cell.config["train"]
        ref = self.cell.reference.Model(cfg, self.weights, dtype=dtype)
        ref.populate()
        losses, grad, params = ref.train(
            N_CHECKED, self._sample(), recipe["lr"], recipe["clip"],
            recipe["eikonal"], generator(self.dev, self.seed, "data"),
            self.lifecycle_seed)
        return {"losses": losses, "grad": grad, "params": params,
                "p0": self.weights}

    def replay_reference(self, dtype=torch.float32) -> dict:
        """The reference's replay of the window's step from the copy made
        before it, with its products in `dtype`."""
        cfg, recipe, b = self.cell.config, self.cell.config["train"], \
            self.before
        ref = self.cell.reference.Model(cfg, b["params"], occ=b["grid"],
                                        dtype=dtype)
        gen = torch.Generator(self.dev)
        gen.set_state(b["gen"])
        losses, grad, params = ref.train(
            1, self._sample(), recipe["lr"], recipe["clip"],
            recipe["eikonal"], gen, self.lifecycle_seed,
            start=self.replay_it, adam={k: b[k] for k in ("m", "v", "t")})
        return {"losses": losses, "grad": grad, "params": params,
                "p0": b["params"]}

    def _numbers(self, first: dict, window: dict) -> Dict[str, float]:
        return {**compare(first, self.reference()),
                **{f"window_{k}": v for k, v in
                   compare(window, self.replay_reference()).items()}}

    def check(self) -> Dict[str, float]:
        return self._numbers(dict(self.first, p0=self.weights),
                             self.replayed)

    def control(self) -> Dict[str, float]:
        """The reference in bfloat16 in the program's place."""
        return self._numbers(self.reference(torch.bfloat16),
                             self.replay_reference(torch.bfloat16))


Cell = TrainCell
