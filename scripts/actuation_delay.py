"""Standing balance with the torques applied late: how many bus ticks of
actuation delay the balance controller tolerates.

The in-process loop of ``ControllerManager`` (read -> update -> write,
one plant step per tick) with the torque computed from the sample of
tick k applied at tick k + ``--delay`` instead of k: the delay that the
two-process loop adds when a bus step takes longer than the controller's
answer. ``--impl torch`` runs the PyTorch port's ``BalanceStandController``
on ``SimHardware`` (``--device``, default the CPU); ``--impl jax`` runs
the JAX package's (on the CPU: set JAX_PLATFORMS=cpu). Prints one JSON
line: ticks run, whether every sample was finite, the base height range,
the last height and speed, the largest torque and the first tick whose
torque passed 100 N·m.

Usage: python scripts/actuation_delay.py --impl torch --delay 1
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _torch_loop(device: str):
    import torch

    from quadruped_locomotion_tpu_torch.runtime import hal, manager
    from quadruped_locomotion_tpu_torch.types import RobotModel

    torch.set_num_threads(1)
    model = RobotModel.simpledog(device)
    hw = hal.SimHardware(model, height=0.4, device=device)
    ctrl = manager.BalanceStandController(model, device=device)
    return hw, ctrl, float(model.torque_limit)


def _jax_loop():
    from quadruped_locomotion_tpu.runtime import hal, manager
    from quadruped_locomotion_tpu.types import RobotModel

    model = RobotModel.simpledog()
    return (hal.SimHardware(model, height=0.4),
            manager.BalanceStandController(model), float(model.torque_limit))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--impl", choices=("torch", "jax"), default="torch")
    ap.add_argument("--delay", type=int, default=1,
                    help="bus ticks between a sample and its torque's use")
    ap.add_argument("--ticks", type=int, default=400)
    ap.add_argument("--device", default="cpu", help="torch only")
    args = ap.parse_args()

    hw, ctrl, limit = (_torch_loop(args.device) if args.impl == "torch"
                       else _jax_loop())
    ctrl.start(hw.read())
    queue = [np.zeros((4, 3), np.float32)] * args.delay
    samples, tau_max = [], []
    t0 = time.perf_counter()
    for _ in range(args.ticks):
        # the manager's clip
        tau = np.clip(np.asarray(ctrl.update(hw.read())), -limit, limit)
        queue.append(tau)
        hw.write(queue.pop(0))
        samples.append(hw.read().pack())
        tau_max.append(float(np.abs(tau).max()))
        if not np.isfinite(samples[-1]).all():
            break
    v = np.stack(samples)
    big = np.flatnonzero(np.asarray(tau_max) > 100.0)
    print(json.dumps(dict(
        impl=args.impl, delay=args.delay, ticks=len(v),
        finite=bool(np.isfinite(v).all()),
        height_min=float(np.nanmin(v[:, 2])),
        height_max=float(np.nanmax(v[:, 2])),
        height_last=float(v[-1, 2]),
        speed_last=float(np.linalg.norm(v[-1, 7:10])),
        tau_max=float(np.nanmax(tau_max)),
        first_tick_over_100=int(big[0]) if big.size else None,
        wall_s=time.perf_counter() - t0)))


if __name__ == "__main__":
    main()
