"""Where ``torch.profiler`` puts the card's operations against the host's
clock: the look behind taking the program's idle split on the host's clock
(``quadruped_locomotion_tpu_torch/utils/logging.idle_intervals``).

    python3 benchmark/probes/profiler_clock.py --windows 4 --warm

Sets up the ``qp.balance`` cell's caller (``drivers/fd_qp.py``), then
traces ``--windows`` windows of its 300 calls under CUDA activity alone,
one profiler session each (``--warm`` opens and closes one tiny session
first). An operation cannot start on the card before the host's runtime
call that launched it, so ``start - launch`` (both on the profiler's
timeline, joined by correlation id) is the launch's latency plus any wait
in the queue, never below zero on one clock. Per window one JSON line
gives its least, median and greatest value in µs, how many operations
read below zero, and how far the host's wall clock moved against its
monotonic clock over the window. Needs a CUDA card.
"""

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH_DIR.parent))

SEED = 2**31 + 11


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--windows", type=int, default=4)
    ap.add_argument("--warm", action="store_true")
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    from benchmark.drivers import fd_qp
    from benchmark.harness import spec
    from benchmark.harness.outcome import Context
    from quadruped_locomotion_tpu_torch.utils import logging as qlog

    if not torch.cuda.is_available():
        print("profiler_clock: CUDA is not available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    ctx = Context(cell=spec.load_cell("qp.balance"), seed=SEED, seconds=0.0,
                  trace=True, device=dev, t0=time.time())
    s = fd_qp.setup(ctx)
    if args.warm:
        with profile(activities=[ProfilerActivity.CUDA]):
            torch.zeros(1, device=dev).add_(1)
            torch.cuda.synchronize()
    for w in range(args.windows):
        torch.cuda.synchronize()
        wall0 = time.time_ns() - time.perf_counter_ns()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fd_qp.window(ctx, s, fd_qp.TRACED_CALLS)
            torch.cuda.synchronize()
        wall1 = time.time_ns() - time.perf_counter_ns()
        lat = [(op.start_ns - op.launch_ns) / 1e3
               for op in qlog.profiler_device_ops(prof)
               if op.launch_ns is not None]
        print(json.dumps({
            "window": w, "ops": len(lat),
            "start_minus_launch_us": [min(lat), statistics.median(lat),
                                      max(lat)],
            "ops_before_their_launch": sum(v < 0 for v in lat),
            "wall_clock_moved_us": (wall1 - wall0) / 1e3}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
