"""Hardware abstraction layer (≙ ``quadruped_locomotion_tpu/runtime/hal.py``):
the fixed wire layouts of a robot sample and a command, and the robot
backends behind them.

* :class:`SimHardware` — the port's massless plant (``rollout/
  simulator.py``) as the robot, on an explicit device. On the card one
  bus tick (plant step, contact sensor, packing) is one CUDA graph,
  captured on the first ``write``: a tick is one host-to-device copy of
  12 torques, one replay and one device-to-host copy of 55 floats. On
  the CPU the same function runs eagerly.
* :class:`ShmHardware` — an out-of-process robot over the shared-memory
  rings of :mod:`.shm`.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..rollout import simulator as simlib
from ..types import RobotModel, resolve_device
from .graph import Tick

# RobotSample layout (floats): the read side of the robot handle
#   0:3   base position (world)
#   3:7   base quaternion wxyz
#   7:10  base linear velocity (world)
#   10:13 base angular velocity (base)
#   13:25 joint positions (4 legs × 3)
#   25:37 joint velocities
#   37:49 joint efforts (measured)
#   49:53 foot contact flags
#   53    e-stop flag
#   54    timestamp (s)
SAMPLE_FLOATS = 55

# CommandSample layout (floats): the write side
#   0:12  joint effort commands
#   12    control mode id (diagnostic)
#   13    e-stop acknowledge
COMMAND_FLOATS = 14


@dataclasses.dataclass
class RobotSample:
    base_position: np.ndarray  # (3,)
    base_quaternion: np.ndarray  # (4,)
    base_linear_velocity: np.ndarray  # (3,)
    base_angular_velocity: np.ndarray  # (3,)
    q: np.ndarray  # (4,3)
    qd: np.ndarray  # (4,3)
    tau: np.ndarray  # (4,3)
    contacts: np.ndarray  # (4,) bool
    estop: bool
    time: float

    def pack(self) -> np.ndarray:
        v = np.empty(SAMPLE_FLOATS, np.float32)
        v[0:3] = self.base_position
        v[3:7] = self.base_quaternion
        v[7:10] = self.base_linear_velocity
        v[10:13] = self.base_angular_velocity
        v[13:25] = np.asarray(self.q, np.float32).ravel()
        v[25:37] = np.asarray(self.qd, np.float32).ravel()
        v[37:49] = np.asarray(self.tau, np.float32).ravel()
        v[49:53] = np.asarray(self.contacts, np.float32)
        v[53] = 1.0 if self.estop else 0.0
        v[54] = self.time
        return v

    @classmethod
    def unpack(cls, v: np.ndarray) -> "RobotSample":
        return cls(
            base_position=v[0:3].copy(),
            base_quaternion=v[3:7].copy(),
            base_linear_velocity=v[7:10].copy(),
            base_angular_velocity=v[10:13].copy(),
            q=v[13:25].reshape(4, 3).copy(),
            qd=v[25:37].reshape(4, 3).copy(),
            tau=v[37:49].reshape(4, 3).copy(),
            contacts=v[49:53] > 0.5,
            estop=bool(v[53] > 0.5),
            time=float(v[54]),
        )


def pack_command(tau: np.ndarray, mode: int = 0, estop: bool = False):
    v = np.zeros(COMMAND_FLOATS, np.float32)
    v[0:12] = np.asarray(tau, np.float32).ravel()
    v[12] = float(mode)
    v[13] = 1.0 if estop else 0.0
    return v


def unpack_command(v: np.ndarray):
    return v[0:12].reshape(4, 3).copy(), int(v[12]), bool(v[13] > 0.5)


class HardwareInterface:
    """read → control → write contract (≙ the robot state interface)."""

    def read(self) -> RobotSample:
        raise NotImplementedError

    def write(self, tau: np.ndarray, mode: int = 0) -> None:
        raise NotImplementedError

    def estop(self) -> None:
        raise NotImplementedError


def pack_sim(sim: simlib.SimState) -> torch.Tensor:
    """The (SAMPLE_FLOATS,) wire vector of an unbatched sim state, e-stop
    0 (the flag is latched on the host)."""
    r = sim.robot
    f32 = torch.float32
    return torch.cat([
        r.base.position, r.base.quaternion, r.base.linear_velocity,
        r.base.angular_velocity, r.q.reshape(12), r.qd.reshape(12),
        r.tau.reshape(12), simlib.contact_sensor(sim).to(f32),
        torch.zeros_like(sim.time).reshape(1), sim.time.reshape(1),
    ]).to(f32)


def _leaves(obj) -> list[torch.Tensor]:
    if isinstance(obj, torch.Tensor):
        return [obj]
    return [t for f in dataclasses.fields(obj)
            for t in _leaves(getattr(obj, f.name))]


class SimHardware(HardwareInterface):
    """In-process plant: the port's massless simulator as the robot,
    standing at ``height`` on ``device`` (default CUDA, which raises where
    CUDA is absent)."""

    def __init__(self, model: RobotModel, dt: float = 0.0025,
                 height: float = 0.4, support=None, device=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.dt = dt
        self.sim = simlib.default_stance_state(self.model, height=height)
        self._support = torch.ones(4, dtype=torch.bool, device=self.device)
        if support is not None:
            self.set_support(support)
        self._tau = torch.zeros((4, 3), dtype=torch.float32,
                                device=self.device)
        self._out = torch.zeros(SAMPLE_FLOATS, dtype=torch.float32,
                                device=self.device)
        self._tick: Tick | None = None
        self._estop = False
        self._vec: np.ndarray | None = None  # packed-sample cache

    def _step_pack(self) -> None:
        """One bus tick on the static buffers: step the plant with the
        torques in ``_tau``, write the new state in place and its packed
        sample into ``_out``."""
        sim2 = simlib.step(self.model, self.sim, self._tau, self.dt,
                           support=self._support)
        for dst, src in zip(_leaves(self.sim), _leaves(sim2)):
            dst.copy_(src)
        self._out.copy_(pack_sim(sim2))

    def set_support(self, support) -> None:
        self._support.copy_(torch.as_tensor(np.asarray(support, bool)))

    def read_packed(self) -> np.ndarray:
        """The (SAMPLE_FLOATS,) wire vector of the current state."""
        if self._vec is None:
            self._vec = pack_sim(self.sim).cpu().numpy()
        vec = self._vec.copy()
        vec[53] = 1.0 if self._estop else 0.0
        return vec

    def read(self) -> RobotSample:
        return RobotSample.unpack(self.read_packed())

    def write(self, tau: np.ndarray, mode: int = 0) -> None:
        if self._estop:
            tau = np.zeros((4, 3), np.float32)
        if self._tick is None:  # capture on the card, eager on the CPU
            self._tick = Tick(self._step_pack, self.device,
                              keep=_leaves(self.sim))
        self._tau.copy_(torch.from_numpy(
            np.ascontiguousarray(tau, np.float32).reshape(4, 3)))
        self._tick()
        self._vec = self._out.cpu().numpy().copy()

    def estop(self) -> None:
        self._estop = True


class ShmHardware(HardwareInterface):
    """Out-of-process robot over the shared-memory rings: reads the
    latest RobotSample from the state ring and publishes commands to the
    command ring."""

    def __init__(self, state_ring, cmd_ring, sync: bool = True):
        self.state_ring = state_ring
        self.cmd_ring = cmd_ring
        self.sync = sync  # pace on fresh samples (the bus is the clock)
        self.timeout = 5.0  # default read timeout (s); callers may tune
        self._estop = False
        self._last = None
        self._last_idx = -1
        self._last_t: float | None = None
        self._period = 0.0  # EWMA inter-sample period (s)

    @classmethod
    def connect(cls, prefix: str = "/qlt"):
        from .shm import ShmRing

        return cls(ShmRing.open(prefix + "_state"),
                   ShmRing.open(prefix + "_cmd"))

    @staticmethod
    def create_rings(prefix: str = "/qlt", n_slots: int = 64):
        """Bus-process side: allocate both rings."""
        from .shm import ShmRing

        state = ShmRing.create(prefix + "_state", SAMPLE_FLOATS, n_slots)
        cmd = ShmRing.create(prefix + "_cmd", COMMAND_FLOATS, n_slots)
        return state, cmd

    def read(self, timeout: float | None = None) -> RobotSample:
        """Latest robot sample. With ``sync``, blocks until a sample newer
        than the previous one arrives (the bus is the clock): one coarse
        sleep sized from the measured inter-sample period up to just short
        of the next expected arrival, then a 100 µs poll. Past ``timeout``
        (default ``self.timeout``) it returns the last sample, or raises
        TimeoutError if none has arrived yet."""
        if timeout is None:
            timeout = self.timeout
        now = time.monotonic()
        deadline = now + timeout
        if self.sync and self._last_t is not None and self._period > 0:
            target = self._last_t + 0.85 * self._period
            coarse = min(target, deadline) - now - 0.0003
            if coarse > 0.0002:
                time.sleep(coarse)
        while True:
            got = self.state_ring.pop_latest(SAMPLE_FLOATS)
            if got is not None:
                idx, vec = got
                if not self.sync or idx > self._last_idx:
                    now = time.monotonic()
                    if self._last_t is not None and idx == self._last_idx + 1:
                        dt = now - self._last_t
                        if 0.0 < dt < 0.1:
                            self._period = (dt if self._period == 0.0
                                            else 0.9 * self._period + 0.1 * dt)
                    self._last_t = now
                    self._last_idx = idx
                    self._last = RobotSample.unpack(vec)
                    return self._last
            if time.monotonic() >= deadline:
                if self._last is None:
                    raise TimeoutError("no robot state published yet")
                return self._last  # bus stalled: reuse the latest
            time.sleep(0.0001)

    def write(self, tau: np.ndarray, mode: int = 0) -> None:
        self.cmd_ring.push(pack_command(tau, mode, self._estop))

    def estop(self) -> None:
        self._estop = True
        self.cmd_ring.push(pack_command(np.zeros((4, 3), np.float32), 0, True))
