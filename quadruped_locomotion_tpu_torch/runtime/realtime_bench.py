"""The cross-process realtime runtime, measured: rates, jitter, e-stop
latency (≙ ``quadruped_locomotion_tpu/runtime/realtime_bench.py``).

Two OS processes (``spawn``):

* the **bus process** — the robot: a ``SimHardware`` plant on
  ``bus_device``, paced at the target rate by a deadline scheduler; it
  publishes a ``RobotSample`` every tick, applies the newest command, and
  on an e-stop command zeroes the torques and latches the flag into every
  later sample;
* the **controller process** (the caller) — ``ControllerManager`` +
  ``BalanceStandController`` on ``device`` over ``ShmHardware`` in sync
  mode: the bus is the clock.

Both devices are explicit and default to the card; nothing switches
device on its own. :func:`measure` returns the controller's rate and
inter-tick jitter (deviation from the nominal period), the bus's, and
the e-stop round trip: wall time from the controller's ``estop()`` to
the first sample it reads with the e-stop latch set; the bus counts its
ticks that found no new command and applied the previous one again
(``bus_held_ticks``). It also reports the
robot's state: the ticks that kept the previous torques and the first
such tick's record, whether every sample read was finite, and the base
height and speed of the last sample before the e-stop.

Run it through ``scripts/measure_realtime_torch.py``: under ``python -m``
the ``spawn`` children re-import the entry module as ``__mp_main__``,
which is known to hang.
"""

from __future__ import annotations

import gc
import multiprocessing as mp
import os
import time

import numpy as np
import torch

BUS_PREFIX = "/qlt_torch_rtbench"  # rings: this + "_<pid>" + "_state" / "_cmd"
FIRST_COMMAND_WINDOW_S = 600.0  # the bus waits this long for the controller


def contention_factor(n_bench_procs: int = 2) -> float:
    """Expected slowdown (≥ 1) from sharing ``os.cpu_count()`` cores with
    the running load (1-minute loadavg) plus the bench's own processes."""
    ncpu = os.cpu_count() or 1
    try:
        load = os.getloadavg()[0]
    except OSError:  # pragma: no cover
        load = 0.0
    return max(1.0, (load + n_bench_procs) / ncpu)


def _try_realtime_priority(prio: int = 10, cpu: int | None = None,
                           fifo: bool = True) -> bool:
    """Ask for SCHED_FIFO (``fifo``) or nice(-15), optionally pinned to
    core ``cpu``; without privileges nothing changes. Returns whether an
    elevated class or priority is active. The paced bus sleeps every tick,
    so FIFO is safe there; the sync-reading controller polls and gets the
    nice level and a core of its own."""
    ok = False
    if fifo:
        try:
            os.sched_setscheduler(0, os.SCHED_FIFO, os.sched_param(prio))
            ok = True
        except (OSError, AttributeError, PermissionError):
            pass
    else:
        try:
            os.nice(-15)
            ok = True
        except OSError:  # pragma: no cover
            pass
    if cpu is not None:
        try:
            os.sched_setaffinity(0, {cpu % (os.cpu_count() or 1)})
        except (OSError, AttributeError):  # pragma: no cover
            pass
    return ok


def _procs_running() -> int:
    """Runnable tasks now (``/proc/stat``), without loadavg's lag."""
    try:
        with open("/proc/stat") as f:
            for line in f:
                if line.startswith("procs_running"):
                    return int(line.split()[1])
    except OSError:  # pragma: no cover
        pass
    return 1


def window_contention(samples: list[int], n_bench_procs: int = 2) -> float:
    """Runnable tasks per CPU (≥ 1) over samples taken in the window."""
    if not samples:
        return 1.0
    return max(1.0, float(np.mean(samples)) / (os.cpu_count() or 1))


def _jitter(dt: np.ndarray, period: float, prefix: str) -> dict:
    dev = np.abs(dt - period)
    return {f"{prefix}jitter_p{p}": float(np.percentile(dev, p))
            for p in (50, 95, 99)}


def bus_main(prefix: str, rate_hz: float, max_ticks: int, stats_q,
             device: str, plant_dt: float | None = None) -> None:
    """The robot bus process (spawn target): paced at ``rate_hz``, each
    tick steps the plant by ``plant_dt`` (default ``1 / rate_hz``)."""
    torch.set_num_threads(1)  # a 12-DoF plant gains nothing from a pool
    from ..types import RobotModel, full_f32_matmuls
    from . import hal
    from .shm import ShmRing

    full_f32_matmuls()
    state_ring = ShmRing.open(prefix + "_state")
    cmd_ring = ShmRing.open(prefix + "_cmd")
    robot = hal.SimHardware(RobotModel.simpledog(device),
                            dt=plant_dt or 1.0 / rate_hz, device=device)
    # liveness first, then the first write, which builds (and on the card
    # captures) the bus tick
    state_ring.push(robot.read_packed())
    robot.write(np.zeros((4, 3), np.float32))
    robot.read()

    period = 1.0 / rate_hz
    tau = np.zeros((4, 3), np.float32)
    last_cmd = -1
    estopped = False
    tick_times = []
    estop_seen_t = None
    step_s = []
    held = 0  # ticks before the e-stop that found no new command

    # the paced run starts when the controller publishes its first command
    deadline = time.monotonic() + FIRST_COMMAND_WINDOW_S
    synced = False
    while time.monotonic() < deadline:
        got = cmd_ring.pop_latest(hal.COMMAND_FLOATS)
        if got is not None:
            last_cmd = got[0]
            tau, _mode, _estop = hal.unpack_command(got[1])
            synced = True
            break
        time.sleep(0.001)
    if not synced:  # pragma: no cover — the controller never came up
        stats_q.put({"bus_ticks": 0, "bus_error": "no first command"})
        state_ring.close()
        cmd_ring.close()
        return

    gc.collect()
    gc.freeze()
    gc.disable()  # no collector pauses inside the paced window
    _try_realtime_priority(11, cpu=1)  # the bus is the clock: core 1
    next_t = time.perf_counter()
    for _ in range(max_ticks):
        tick_times.append(time.perf_counter())
        got = cmd_ring.pop_latest(hal.COMMAND_FLOATS)
        if got is not None and got[0] > last_cmd:
            last_cmd = got[0]
            tau, _mode, estop = hal.unpack_command(got[1])
            if estop and not estopped:
                estopped = True
                estop_seen_t = time.perf_counter()
                robot.estop()  # zero torque + latch the flag
        elif not estopped:
            held += 1
        if estopped:
            tau = np.zeros((4, 3), np.float32)
        t0 = time.perf_counter()
        robot.write(tau)
        step_s.append(time.perf_counter() - t0)
        state_ring.push(robot.read_packed())
        next_t += period
        delay = next_t - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        if (estopped and len(tick_times) > 8
                and time.perf_counter() - estop_seen_t > 0.1):
            break  # drained past the e-stop

    dt = np.diff(np.asarray(tick_times))
    if dt.size == 0:  # pragma: no cover — degenerate window
        stats_q.put({"bus_ticks": len(tick_times),
                     "bus_error": "too few ticks"})
    else:
        stats = {"bus_ticks": len(tick_times),
                 "bus_rate_hz": float(1.0 / dt.mean()),
                 "bus_step_ms_p50": float(np.percentile(step_s, 50) * 1e3),
                 "bus_held_ticks": held,
                 "bus_estopped": estopped}
        stats.update(_jitter(dt, period, "bus_"))
        stats_q.put(stats)
    state_ring.close()
    cmd_ring.close()


def measure(duration_s: float = 4.0, rate_hz: float = 400.0,
            estop_at_s: float | None = None, prefix: str | None = None,
            device=None, bus_device=None,
            plant_dt: float | None = None) -> dict:
    """Run the two-process loop for ``duration_s`` of controller ticks at
    ``rate_hz`` and return the timing report. ``estop_at_s`` (default 80 %
    of the run) triggers the controller-side e-stop. ``device`` and
    ``bus_device`` place the controller and the plant (default CUDA for
    both; where CUDA is absent a default raises). ``prefix`` names the
    two rings (default ``BUS_PREFIX`` and this process's id, so that two
    runs on one machine never share a ring); the report carries it.

    ``plant_dt`` is the plant's step per bus tick, default ``1 / rate_hz``
    (the robot in real time). With a longer bus period than ``plant_dt``
    the robot runs slower than real time, so that a controller slower
    than the real-time period still answers each sample before the bus's
    next tick."""
    from ..types import resolve_device
    from .hal import ShmHardware
    from .shm import ShmRing

    device = resolve_device(device)
    bus_device = resolve_device(bus_device)
    if estop_at_s is None:
        estop_at_s = 0.8 * duration_s
    n_ticks = int(duration_s * rate_hz)
    estop_tick = int(estop_at_s * rate_hz)
    if prefix is None:
        prefix = f"{BUS_PREFIX}_{os.getpid()}"
    plant_dt = plant_dt or 1.0 / rate_hz

    state_ring, cmd_ring = ShmHardware.create_rings(prefix)
    try:
        report = _measure_inner(prefix, rate_hz, n_ticks, estop_tick,
                                state_ring, cmd_ring, device, bus_device,
                                plant_dt)
    finally:
        # an aborted run must not leak the rings
        for ring, name in ((state_ring, "_state"), (cmd_ring, "_cmd")):
            ring.close()
            ShmRing.unlink(prefix + name)
    report.update(device=str(device), bus_device=str(bus_device),
                  prefix=prefix, plant_dt=plant_dt)
    return report


def _restore_scheduling(orig_affinity, orig_nice) -> None:
    try:
        os.sched_setscheduler(0, os.SCHED_OTHER, os.sched_param(0))
    except (OSError, AttributeError):  # pragma: no cover
        pass
    if orig_affinity is not None:
        try:
            os.sched_setaffinity(0, orig_affinity)
        except OSError:  # pragma: no cover
            pass
    if orig_nice is not None:
        try:
            os.setpriority(os.PRIO_PROCESS, 0, orig_nice)
        except OSError:  # pragma: no cover
            pass


def _measure_inner(prefix, rate_hz, n_ticks, estop_tick, state_ring,
                   cmd_ring, device, bus_device, plant_dt) -> dict:
    from ..types import RobotModel, full_f32_matmuls
    from .hal import ShmHardware
    from .manager import BalanceStandController, ControllerManager

    full_f32_matmuls()
    period = 1.0 / rate_hz
    ctx = mp.get_context("spawn")
    stats_q = ctx.Queue()
    bus = ctx.Process(
        target=bus_main,
        args=(prefix, rate_hz, n_ticks + int(2.0 * rate_hz), stats_q,
              str(bus_device), plant_dt),
        daemon=True)
    bus.start()
    try:
        model = RobotModel.simpledog(device)
        hw = ShmHardware(state_ring, cmd_ring)
        mgr = ControllerManager(hw, model, dt=plant_dt)
        ctrl = BalanceStandController(model, device=device)
        mgr.register(ctrl)

        # the first read waits for the bus; switch + warmup build and
        # capture both controller variants before the first command,
        # which releases the bus into its paced run
        sample0 = hw.read(timeout=300.0)
        # the bus publishes nothing new until the first command, so the
        # reads of the switch and the first tick return the liveness
        # sample after this bounded stale-read wait (a dead bus must not
        # cost seconds per tick in the window either)
        hw.timeout = 0.5
        mgr.switch(ctrl.name)
        ctrl.warmup(sample0)
        mgr.tick()
        hw.read(timeout=300.0)  # the bus's first paced sample

        gc.collect()
        gc.freeze()
        gc.disable()  # no collector pauses inside the measured window
        orig_affinity = orig_nice = None
        try:
            orig_affinity = os.sched_getaffinity(0)
            orig_nice = os.getpriority(os.PRIO_PROCESS, 0)
        except (OSError, AttributeError):  # pragma: no cover
            pass
        rt_active = _try_realtime_priority(cpu=0, fifo=False)
        tick_t, runnable = [], []
        estop_sent_t = estop_seen_t = None
        standing = sample0  # the last sample read before the e-stop
        finite = True  # every sample read was finite
        try:
            for i in range(n_ticks):
                tick_t.append(time.perf_counter())
                if i % 32 == 0:  # contention inside the window (~8 Hz)
                    runnable.append(_procs_running())
                    if not bus.is_alive():
                        break
                if i == estop_tick and estop_sent_t is None:
                    estop_sent_t = time.perf_counter()
                    mgr.estop()
                sample = mgr.tick()
                finite = finite and bool(np.isfinite(sample.pack()).all())
                if estop_sent_t is None:
                    standing = sample
                if (estop_sent_t is not None and estop_seen_t is None
                        and sample.estop):
                    estop_seen_t = time.perf_counter()
                    for _ in range(8):  # drain a few ticks, then stop
                        mgr.tick()
                    break
        finally:
            gc.enable()
            _restore_scheduling(orig_affinity, orig_nice)
        bus_stats = stats_q.get(timeout=60.0)  # drain before joining
        bus.join(timeout=60.0)
    finally:
        if bus.is_alive():
            bus.kill()
            bus.join(timeout=10.0)

    dt = np.diff(np.asarray(tick_t))
    dt = dt[10:] if dt.size > 30 else dt  # scheduler settling
    if dt.size == 0:  # pragma: no cover — degenerate window
        dt = np.asarray([np.inf])
    report = {
        "rate_hz_nominal": rate_hz,
        "controller_ticks": len(tick_t),
        "controller_rate_hz": float(1.0 / dt.mean()),
        "estop_latency_s": (None if estop_seen_t is None
                            else float(estop_seen_t - estop_sent_t)),
        "kept_previous": mgr.kept_previous,
        "first_failure": mgr.first_failure,
        "samples_finite": finite,
        "height_before_estop": float(standing.base_position[2]),
        "speed_before_estop": float(
            np.linalg.norm(standing.base_linear_velocity)),
        "contention_window": window_contention(runnable),
        "runnable_mean": float(np.mean(runnable)) if runnable else 0.0,
        "rt_priority": rt_active,
    }
    report.update(_jitter(dt, period, ""))
    report.update(bus_stats)
    return report
