"""The readings that a cell's correctness limits are set from, in one
process on the card:

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 \
        --control-seeds 1,2,3 [--fault-seeds 1,2,3] [--seconds 3]

For each seed: the cell's set-up, for render cells a short window at the
cell's own load (long enough to fill the frames the check compares; a
training cell steps on to the window step the check replays), the
program freed, then the numbers the check compares (program against
reference); on the control seeds the same numbers for the reference in
bfloat16 put in the program's place; on the fault seeds (training cells)
the numbers of a program whose loss leaves out half of the batch and
takes the mean over the rest. One JSON line a seed. The benchmark's own
runs never run this."""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

import run  # noqa: E402  (sets the paths and the cache directories)


def half_batch(cell):
    """The cell with its recipe's loss taken over the first half of the
    batch's rays only (the mean over the rest)."""
    import copy
    import functools
    import types

    half = copy.copy(cell)
    rows = cell.traffic["rays_per_step"] // 2
    half.recipe = types.SimpleNamespace(
        sample=cell.recipe.sample,
        loss=functools.partial(cell.recipe.loss, rows=rows))
    return half


def leaf_gaps(prog: dict, ref: dict) -> dict:
    """Each leaf's gap, as `harness.train.norm_gap` measures the worst."""
    import statistics

    import torch

    n = lambda t: float(torch.linalg.norm(t.double()))
    nr = {k: n(v) for k, v in ref.items()}
    med = statistics.median(nr.values())
    return {k: abs(n(prog[k]) - nr[k]) / max(nr[k], med, 1e-30)
            for k in ref}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    ints = lambda s: [int(v) for v in s.split(",") if v]
    import torch

    from harness import program, spec

    run.settle(torch)
    cell = spec.find_cell(args.workload, spec.load_benchmark(run.ROOT))
    dev = torch.device("cuda", 0)
    training = cell.traffic["kind"] == "train"
    controls, faults = set(ints(args.control_seeds)), \
        set(ints(args.fault_seeds))

    def ready(c, seed):
        r = c.driver(c, seed, dev)
        r.setup()
        if not training:
            out["frames"] = r.window(args.seconds)["attempted"]
        r.free_program()
        return r

    for seed in ints(args.seeds):
        out = {"seed": seed}
        t = time.perf_counter()
        r = ready(cell, seed)
        out["setup_s"] = time.perf_counter() - t
        t = time.perf_counter()
        out["check"] = r.check()
        out["check_s"] = time.perf_counter() - t
        if training:
            out["replayed_step"] = r.replay_it
            out["grad_leaves"] = leaf_gaps(r.first["grad"],
                                           r.reference()["grad"])
        if seed in controls:
            t = time.perf_counter()
            out["control"] = r.control()
            out["control_s"] = time.perf_counter() - t
        del r
        program.release(dev)
        if seed in faults and training:
            out["fault_half_batch"] = ready(half_batch(cell), seed).check()
            program.release(dev)
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
