"""Run one cell of the benchmark of nr3d_lib_tpu_torch on this machine's
card and print its result as the last line of standard output:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (imports, the weights and inputs made on the device from the
seed, the warm-up of every shape the cell uses, and on a checkout's
first run the nvcc build) is `setup_s`. Then the cell runs for
`--seconds`: with `--trace 0` it reports the end-to-end metrics, with
`--trace 1` it traces stretches of the window and reports the per-layer
metrics. Afterwards the program is freed and what the window produced is
checked against the plain reference under `benchmark/reference/`.

Exits 2 without a result when there is no card (or fewer than the cell
asks for), 3 when JAX or the JAX package was loaded, 1 on any other
failure."""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT)]
# every kernel cache at a fixed path inside the checkout
os.environ["TRITON_CACHE_DIR"] = str(ROOT / ".bench_cache" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / ".bench_cache" / "torch_ext")


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def device_info(torch, dev, peak: int) -> dict:
    """The card the run used: its name, the card count, the peak memory
    and the power limit in watts (from nvidia-smi; None where it cannot
    be read)."""
    import subprocess

    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0, "power_limit_w": None}
    try:
        limit = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", str(dev.index or 0)],
            capture_output=True, text=True, timeout=30).stdout
        limit_w = float(limit.split()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        limit_w = None
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": 1, "memory_peak_bytes": int(peak),
            "power_limit_w": limit_w}


def settle(torch) -> None:
    """The process's settings for a run: float32 products stay float32
    (PyTorch's default, stated here), and one intra-op thread. The
    program's host work is dispatch from one thread; torch's default
    pool of a thread a core took host time from it (a training step's
    rate 38-54 a second over processes with eight threads, 49-59 with
    one, on the H100's 8-core host)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(1)


def execute(cell, seed: int, seconds: float, trace: bool, dev,
            t_start: float) -> dict:
    """Set-up, the window, the check: the result line of one run on the
    device `dev` (the card; tests drive it on the CPU at small sizes)."""
    import torch

    from harness import guard, program, readers

    settle(torch)
    run = cell.driver(cell, seed, dev, traced=trace)
    run.setup()
    setup_peak = program.peak_bytes(dev)
    setup_s = time.perf_counter() - t_start
    print(f"[setup] {setup_s:.3f} s", file=sys.stderr)

    if trace:
        res = run.traced_window(seconds)
        tr = res["trace"]
        metrics = {}
        for m in cell.per_layer:
            value = cell.readers[m["name"]](readers.Context(cell, tr, run))
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        res = run.window(seconds)
        units = {m["name"]: m["unit"] for m in cell.end_to_end}
        values = dict(res["metrics"], setup_s=setup_s,
                      peak_mem_mib=res["peak"] / 2 ** 20)
        metrics = {k: {"value": v, "unit": units[k]}
                   for k, v in values.items() if k in units}
    device = device_info(torch, dev, max(setup_peak, res["peak"]))
    if trace:
        device.update(busy_s=tr.busy_s, window_s=tr.window_s)

    bad = guard.forbidden_loaded()
    if bad:
        raise ForbiddenModules(bad)
    run.free_program()
    t_check = time.perf_counter()
    limits = cell.limits["numbers"]
    checks = {k: {"value": v, "limit": limits[k]["limit"]}
              for k, v in run.check().items()}
    correct = res["failed"] == 0 and \
        all(c["value"] <= c["limit"] for c in checks.values())
    print(f"[check] {time.perf_counter() - t_check:.3f} s", file=sys.stderr)
    print(f"failed {res['failed']} limit 0", file=sys.stderr)
    for k, c in checks.items():
        print(f"{k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    line = {"correct": correct, "attempted": res["attempted"],
            "failed": res["failed"], "metrics": metrics, "device": device}
    if trace:
        line["breakdown"] = tr.breakdown()
    line["checks"] = checks
    return line


class ForbiddenModules(RuntimeError):
    def __init__(self, names):
        super().__init__(f"the run loaded {', '.join(names)}")


def main(argv=None) -> int:
    args = parse(argv)
    from harness import spec

    cell = spec.find_cell(args.workload, spec.load_benchmark(ROOT))
    import torch

    chips = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"run.py: the cell needs {chips} CUDA card(s); "
              f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    try:
        line = execute(cell, args.seed, args.seconds, bool(args.trace),
                       torch.device("cuda", 0), T_START)
    except ForbiddenModules as e:
        print(f"run.py: {e}", file=sys.stderr)
        return 3
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
