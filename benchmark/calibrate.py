"""Readings for a cell's limits, on the chip at the cell's own size: the
program's compared numbers on many seeds and those of the control (the
reference put in the program's place, computed in the precision below
the configuration's) on a few, in one process.

    python3 benchmark/calibrate.py --workload <name> --seeds 1 2 3 ... \\
        --control-seeds 101 102 103

Each seed's readings go to standard output as one JSON line, and to
``<out>/calibrate_<workload>.jsonl`` (``--out``, default
``benchmark/out``). The benchmark's own runs do
not run this; a cell on several cards runs it under torchrun, as
``run.py`` runs itself.
"""

import time

T0 = time.time()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH_DIR.parent))

from benchmark.harness import spec  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--out", type=Path, default=BENCH_DIR / "out")
    args = ap.parse_args()
    cell = spec.load_cell(args.workload)

    import torch

    from benchmark.harness.outcome import Context

    if not torch.cuda.is_available():
        print("calibrate.py: no CUDA card", file=sys.stderr)
        return 2
    rank = int(os.environ.get("RANK", "0"))
    world = int(os.environ.get("WORLD_SIZE", "1"))
    device = torch.device(f"cuda:{int(os.environ.get('LOCAL_RANK', '0'))}")
    driver = importlib.import_module(
        f"benchmark.drivers.{cell.config['driver']}")
    args.out.mkdir(parents=True, exist_ok=True)
    log = args.out / f"calibrate_{args.workload}.jsonl"
    runs = [(s, False) for s in args.seeds] + [
        (s, True) for s in args.control_seeds]
    for seed, control in runs:
        ctx = Context(cell=cell, seed=seed, seconds=0.0, trace=False,
                      device=device, t0=T0, rank=rank, world=world)
        t = time.time()
        got = driver.calibration(ctx, control)
        if rank != 0:
            continue
        got.update(seed=seed, seconds=time.time() - t)
        line = json.dumps(got)
        print(line, flush=True)
        with log.open("a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
