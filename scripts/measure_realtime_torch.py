"""Measure the PyTorch port's cross-process realtime runtime: controller
and bus rates, jitter, e-stop round trip.

Two OS processes talk over the shared-memory rings: a paced bus process
owning the plant (``SimHardware``), and this process running the balance
controller through ``ShmHardware``, each on its own device (default: the
CUDA card for both). Prints one JSON report.

Usage: python scripts/measure_realtime_torch.py [duration_s] [rate_hz]
           [--device cuda|cpu] [--bus-device cuda|cpu] [--estop-at-s S]

The controller e-stops after ``--estop-at-s`` seconds of nominal ticks
(default 80 % of the run).

A plain-file entry on purpose: run as ``python -m``, the ``spawn`` bus
process re-imports the entry module as ``__mp_main__`` and hangs.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from quadruped_locomotion_tpu_torch.runtime.realtime_bench import measure  # noqa: E402

if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("duration_s", nargs="?", type=float, default=4.0)
    ap.add_argument("rate_hz", nargs="?", type=float, default=400.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--bus-device", default="cuda")
    ap.add_argument("--estop-at-s", type=float, default=None)
    args = ap.parse_args()
    print(json.dumps(measure(duration_s=args.duration_s, rate_hz=args.rate_hz,
                             estop_at_s=args.estop_at_s, device=args.device,
                             bus_device=args.bus_device)))
