"""The port's benchmark: one cell of ``BENCHMARK.json``, run once.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the cell's number of
CUDA cards. The run draws its inputs from ``--seed``, builds and warms up
the program (``quadruped_locomotion_tpu_torch``), measures for
``--seconds`` (``--trace 0``: the cell's end-to-end metrics) or profiles
a short window (``--trace 1``: its per-layer metrics), checks what the
timed path produced against the plain reference under
``benchmark/reference/``, and prints one JSON line as the last line of
its standard output, with every number compared beside its limit. A cell
on several cards runs itself again under ``torch.distributed.run``, one
process per card; rank 0 prints the line. Without the cards it asks for,
the run prints no result and exits with code 2.
"""

import time

T0 = time.time()  # the start of the run, for setup_s

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import signal  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH_DIR.parent))

from benchmark.harness import spec  # noqa: E402

FORBIDDEN = {"jax", "jaxlib", "flax", "quadruped_locomotion_tpu"}
T0_ENV = "QLT_BENCHMARK_T0"  # the launcher's start, handed to its ranks
RUN_LIMIT_S = 350.0  # a run on several cards is ended after this
CACHES = {  # fixed directories inside the checkout, so a second run hits
    "TRITON_CACHE_DIR": "triton",
    "TORCH_EXTENSIONS_DIR": "torch_extensions",
    "CUDA_CACHE_PATH": "nv_compute",
}


def _args(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), required=True)
    return ap.parse_args(argv)


def _relaunch(chips: int, argv: list) -> int:
    """This run again under torchrun, one process per card, in its own
    session: a rank that fails ends the others and the launcher exits
    non-zero with the rank's traceback on standard error; a run past
    RUN_LIMIT_S is killed whole."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc_per_node={chips}", str(Path(__file__).resolve()), *argv]
    proc = subprocess.Popen(cmd, env=dict(os.environ, **{T0_ENV: repr(T0)}),
                            start_new_session=True)
    try:
        return proc.wait(timeout=RUN_LIMIT_S - (time.time() - T0))
    except BaseException:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()
        print(f"run.py: the ranks did not end within {RUN_LIMIT_S} s",
              file=sys.stderr)
        return 1


def _metric_line(cell, outcome, trace: bool, device_name: str) -> dict:
    """The result's metrics: the cell's end-to-end metrics, or its
    per-layer metrics from their readers (a reader that finds nothing
    returns None and the metric is left out)."""
    from types import SimpleNamespace

    out = {}
    if not trace:
        for m in cell.end_to_end:
            out[m["name"]] = {"value": outcome.metrics[m["name"]],
                              "unit": m["unit"]}
        return out
    run = SimpleNamespace(trace=outcome.trace, counts=outcome.counts,
                          config=cell.config, device_name=device_name)
    for m in cell.per_layer:
        value = spec.load_reader(m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def measure(cell, seed: int, seconds: float, trace: bool, device, t0: float,
            rank: int = 0, world: int = 1):
    """Run ``cell`` once on ``device``; the result's line (a dict) on rank
    0, None on the others."""
    import torch

    from benchmark.harness.outcome import Context

    from benchmark.harness.outcome import note

    driver = importlib.import_module(f"benchmark.drivers.{cell.config['driver']}")
    ctx = Context(cell=cell, seed=seed, seconds=seconds, trace=trace,
                  device=torch.device(device), t0=t0, rank=rank, world=world)
    note(ctx, "harness imported")
    outcome = driver.run(ctx)
    note(ctx, "window closed and checked")
    if world > 1:
        torch.distributed.destroy_process_group()
    loaded = sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)
    if loaded:
        raise RuntimeError(f"the run loaded {loaded}: the benchmark measures "
                           "the PyTorch port alone")
    if rank != 0:
        return None
    dev = ctx.device
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": name, "count": world,
                   "memory_peak_bytes": outcome.memory_peak_bytes}
    line = {"correct": outcome.correct, "attempted": outcome.attempted,
            "failed": outcome.failed,
            "metrics": _metric_line(cell, outcome, trace, name),
            "device": device_info}
    if trace:
        device_info["busy_s"] = outcome.counts.get("busy_s",
                                                 outcome.trace.busy_s())
        device_info["window_s"] = outcome.trace.window_s
        line["breakdown"] = outcome.trace.breakdown()
    line["checks"] = {k: {"value": v, "limit": lim}
                      for k, (v, lim) in outcome.checks.items()}
    return line


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    args = _args(argv)
    cell = spec.load_cell(args.workload)
    for var, sub in CACHES.items():
        path = BENCH_DIR / ".cache" / sub
        path.mkdir(parents=True, exist_ok=True)
        os.environ[var] = str(path)
    under_launcher = "LOCAL_RANK" in os.environ
    if cell.chips > 1 and not under_launcher:
        return _relaunch(cell.chips, argv)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"run.py: {args.workload} needs {cell.chips} CUDA card(s), "
              f"this machine has {have}", file=sys.stderr)
        return 2
    rank = int(os.environ.get("RANK", "0"))
    world = int(os.environ.get("WORLD_SIZE", "1"))
    device = f"cuda:{int(os.environ.get('LOCAL_RANK', '0'))}"
    t0 = float(os.environ.get(T0_ENV, repr(T0)))
    line = measure(cell, args.seed, args.seconds, bool(args.trace), device,
                   t0, rank, world)
    if line is None:
        return 0
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
