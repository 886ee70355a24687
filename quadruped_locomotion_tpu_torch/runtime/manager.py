"""Controller manager: the fixed-rate read → update → write runtime loop
(≙ ``quadruped_locomotion_tpu/runtime/manager.py``), with e-stop and
controller switching.

Controllers are host objects over static device buffers. Each tick
function is built and captured once, in :meth:`Controller.start` (called
by :meth:`ControllerManager.switch`) or :meth:`Controller.warmup`: on the
card as a CUDA graph (:class:`.graph.Tick`), the port's counterpart of the
JAX package compiling ``_balance_vec_update`` once; an update then copies
the 55-float sample in, replays, and copies 12 torques out. On the CPU the
same functions run eagerly. The balance tick solves its force
distribution with the generic QP of ``ops/qp.py``, as the JAX manager
does, and launches no CUDA kernel of the port's own.

Safety behaviour is the reference's: e-stop forces zero torque, and an
update that raises or returns non-finite torques keeps the previous
torques. Building and capturing happen outside that guard, so a failed
capture or a CUDA fault raises.
"""

from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch

from ..control.balance_controller import balance_update
from ..control.swing import joint_pd_gravity_torques, swing_torques
from ..model.kinematics import forward_kinematics
from ..types import (
    BaseState, BaseTarget, CfdParams, RobotModel, RobotState, SwingGains,
    VmcGains, resolve_device,
)
from .graph import Tick
from .hal import SAMPLE_FLOATS, HardwareInterface, RobotSample

COLD_ITERS, COLD_POLISH = 15, "full"  # first tick after a switch
WARM_ITERS, WARM_POLISH = 8, "light"  # warm-started from the last (x, z)


def _robot_state_from_vec(vec: torch.Tensor, support=None) -> RobotState:
    """A RobotState of the packed (SAMPLE_FLOATS,) wire vector: one tensor
    crosses to the device per tick and is sliced there."""
    base = BaseState(position=vec[0:3], quaternion=vec[3:7],
                     linear_velocity=vec[7:10], angular_velocity=vec[10:13])
    neutral = RobotState.neutral(device=vec.device)
    return neutral.replace(
        base=base, q=vec[13:25].reshape(4, 3), qd=vec[25:37].reshape(4, 3),
        tau=vec[37:49].reshape(4, 3),
        support=neutral.support if support is None else support)


def _balance_vec_update(model, gains, cfd, vec, target, warm, iters, polish):
    """The balance tick on a packed sample → (tau (4,3), (x, z))."""
    state = _robot_state_from_vec(vec)
    tau, diag = balance_update(model, gains, cfd, state, target,
                               qp_iters=iters, warm=warm, polish=polish)
    sol = diag.distribution.qp_solution
    return tau, (sol.x, sol.z)


class Controller:
    """Interface: a torque law over static buffers + lifecycle hooks."""

    name = "controller"

    def start(self, sample: RobotSample) -> None:  # re-init on switch
        pass

    def warmup(self, sample: RobotSample) -> None:
        """Build and capture every tick path without publishing side
        effects: call after :meth:`start`, before a paced loop."""

    def update(self, sample: RobotSample) -> np.ndarray:  # (4,3) torques
        raise NotImplementedError


class _DeviceController(Controller):
    """Shared plumbing: the device, the sample buffer, the torque buffer."""

    def __init__(self, model: RobotModel, device):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        f32 = dict(dtype=torch.float32, device=self.device)
        self._vec = torch.zeros(SAMPLE_FLOATS, **f32)
        self._tau = torch.zeros((4, 3), **f32)

    def _load(self, sample: RobotSample) -> None:
        self._vec.copy_(torch.from_numpy(sample.pack()))

    def _torques(self) -> np.ndarray:
        # a copy: on the CPU ``.cpu().numpy()`` is a view of the buffer
        # that the next update overwrites
        return self._tau.cpu().numpy().copy()


class BalanceStandController(_DeviceController):
    """Whole-body standing balance: VMC → force-distribution QP → stance
    torques toward a held base target (≙ the reference's balance
    controller in its all-stance regime). The first tick after a switch
    runs the cold solve (15 iterations, full polish); later ticks
    warm-start from the previous (x, z) with ``qp_iters`` iterations and
    the light polish. Both variants are captured."""

    name = "base_balance_controller"

    def __init__(self, model: RobotModel, gains: VmcGains | None = None,
                 cfd: CfdParams | None = None, qp_iters: int = WARM_ITERS,
                 device=None):
        super().__init__(model, device)
        dev = self.device
        self.gains = (gains or VmcGains.gazebo_defaults(dev)).to(dev)
        self.cfd = (cfd or CfdParams.defaults(dev)).to(dev)
        self._qp_iters = qp_iters
        f32 = dict(dtype=torch.float32, device=dev)
        self._target = BaseTarget(
            position=torch.zeros(3, **f32), quaternion=torch.zeros(4, **f32),
            linear_velocity=torch.zeros(3, **f32),
            angular_velocity=torch.zeros(3, **f32))
        self._wx = torch.zeros(12, **f32)  # previous tick's QP iterates
        self._wz = torch.zeros(20, **f32)
        self._warm = False
        self._cold: Tick | None = None
        self._warm_tick: Tick | None = None

    def _run(self, warm: bool) -> None:
        tau, (x, z) = _balance_vec_update(
            self.model, self.gains, self.cfd, self._vec, self._target,
            (self._wx, self._wz) if warm else None,
            self._qp_iters if warm else COLD_ITERS,
            WARM_POLISH if warm else COLD_POLISH)
        self._tau.copy_(tau)
        self._wx.copy_(x)
        self._wz.copy_(z)

    def start(self, sample: RobotSample) -> None:
        self._load(sample)
        self.set_target(BaseTarget(
            position=torch.from_numpy(sample.base_position),
            quaternion=torch.from_numpy(sample.base_quaternion),
            linear_velocity=torch.zeros(3), angular_velocity=torch.zeros(3)))
        self._warm = False
        if self._cold is None:
            self._cold = Tick(lambda: self._run(False), self.device)
            self._warm_tick = Tick(lambda: self._run(True), self.device)

    def set_target(self, target: BaseTarget) -> None:
        for dst, src in ((self._target.position, target.position),
                         (self._target.quaternion, target.quaternion),
                         (self._target.linear_velocity, target.linear_velocity),
                         (self._target.angular_velocity,
                          target.angular_velocity)):
            dst.copy_(torch.as_tensor(src))

    def warmup(self, sample: RobotSample) -> None:
        """Run both variants once (the first replay of a graph pays its
        upload) without touching the warm flag or the hardware."""
        if self._cold is None:
            raise RuntimeError("start the controller before warmup")
        self._load(sample)
        self._cold()
        self._warm_tick()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def update(self, sample: RobotSample) -> np.ndarray:
        if self._cold is None:
            raise RuntimeError("start the controller before update")
        self._load(sample)
        if self._warm:
            self._warm_tick()
        else:
            self._cold()
            self._warm = True
        return self._torques()


class SingleLegController(_DeviceController):
    """Task-space computed-torque control of selected legs toward
    end-effector targets, gravity-compensated PD hold on the rest
    (≙ the reference's single-leg controller)."""

    name = "single_leg_controller"

    def __init__(self, model: RobotModel, legs=(0,),
                 gains: SwingGains | None = None, device=None):
        super().__init__(model, device)
        self.gains = (gains or SwingGains.defaults(self.device)).to(self.device)
        self._active = torch.zeros(4, dtype=torch.bool, device=self.device)
        self._active[list(legs)] = True
        self._p_des = torch.zeros((4, 3), dtype=torch.float32,
                                  device=self.device)  # base-frame targets
        self._q_hold = torch.zeros_like(self._p_des)
        self._tick: Tick | None = None

    def _run(self) -> None:
        state = _robot_state_from_vec(self._vec, torch.zeros_like(self._active))
        zero = torch.zeros_like(self._p_des)
        tau_task = swing_torques(self.model, self.gains, state, self._p_des,
                                 zero, zero)
        tau_hold = joint_pd_gravity_torques(self.model, state, self._q_hold,
                                            zero)
        self._tau.copy_(torch.where(self._active[:, None], tau_task, tau_hold))

    def start(self, sample: RobotSample) -> None:
        self._load(sample)
        self._q_hold.copy_(torch.from_numpy(sample.q))
        self._p_des.copy_(forward_kinematics(self.model, self._q_hold))
        if self._tick is None:
            self._tick = Tick(self._run, self.device)

    def set_targets(self, p_des_base) -> None:
        self._p_des.copy_(torch.as_tensor(p_des_base))

    def update(self, sample: RobotSample) -> np.ndarray:
        if self._tick is None:
            raise RuntimeError("start the controller before update")
        self._load(sample)
        self._tick()
        return self._torques()


class JointTorqueController(Controller):
    """Forward externally set joint efforts (≙ the joint torque
    controller)."""

    name = "joint_torque_controller"

    def __init__(self):
        self.command = np.zeros((4, 3), np.float32)

    def update(self, sample: RobotSample) -> np.ndarray:
        return self.command


class FreezeController(_DeviceController):
    """PD-hold the joint positions captured at switch time — the safe
    fallback."""

    name = "freeze_controller"

    def __init__(self, model: RobotModel, device=None):
        super().__init__(model, device)
        self._q_hold = torch.zeros((4, 3), dtype=torch.float32,
                                   device=self.device)
        self._tick: Tick | None = None

    def _run(self) -> None:
        state = _robot_state_from_vec(
            self._vec, torch.zeros(4, dtype=torch.bool, device=self.device))
        self._tau.copy_(joint_pd_gravity_torques(
            self.model, state, self._q_hold, torch.zeros_like(self._q_hold)))

    def start(self, sample: RobotSample) -> None:
        self._load(sample)
        self._q_hold.copy_(torch.from_numpy(sample.q))
        if self._tick is None:
            self._tick = Tick(self._run, self.device)

    def update(self, sample: RobotSample) -> np.ndarray:
        if self._tick is None:
            raise RuntimeError("start the controller before update")
        self._load(sample)
        self._tick()
        return self._torques()


class ControllerManager:
    """Fixed-rate runtime loop with switching and e-stop."""

    def __init__(self, hw: HardwareInterface, model: RobotModel,
                 dt: float = 0.0025):  # 400 Hz
        self.hw = hw
        self.model = model
        self.dt = dt
        self.controllers: dict[str, Controller] = {}
        self.active: Controller | None = None
        self.estopped = False
        self._last_tau = np.zeros((4, 3), np.float32)
        self._limit = float(model.torque_limit)
        self.ticks = 0
        self.kept_previous = 0  # ticks whose update raised or was not finite
        self.first_failure: dict | None = None  # the first such tick's record

    def register(self, ctrl: Controller) -> None:
        self.controllers[ctrl.name] = ctrl

    def switch(self, name: str) -> None:
        """Start ``name`` from the current sample and make it active."""
        ctrl = self.controllers[name]
        ctrl.start(self.hw.read())
        self.active = ctrl

    def estop(self) -> None:
        self.estopped = True
        self.hw.estop()

    def tick(self) -> RobotSample:
        """One read → update → write cycle."""
        sample = self.hw.read()
        if self.estopped or sample.estop:
            tau = np.zeros((4, 3), np.float32)
        elif self.active is None:
            tau = self._last_tau
        else:
            try:
                tau = self.active.update(sample)
                bad = ~np.isfinite(tau)
                if bad.any():
                    raise FloatingPointError(
                        f"non-finite torques at (leg, joint) "
                        f"{np.argwhere(bad).tolist()}")
                self._last_tau = tau
            except Exception as exc:
                # keep the previous torques (the reference's balance
                # controller on a failed update)
                tau = self._last_tau
                self.kept_previous += 1
                if self.first_failure is None:
                    self.first_failure = dict(
                        tick=self.ticks, controller=self.active.name,
                        error=f"{type(exc).__name__}: {exc}",
                        sample_finite=bool(np.isfinite(sample.pack()).all()))
        tau = np.clip(tau, -self._limit, self._limit)
        self.hw.write(tau)
        self.ticks += 1
        return sample

    def run(self, n_ticks: int, realtime: bool = False,
            on_sample: Callable[[RobotSample], None] | None = None) -> None:
        """The 400 Hz loop; ``realtime=False`` runs as fast as the backend
        steps (sim time)."""
        next_t = time.perf_counter()
        for _ in range(n_ticks):
            sample = self.tick()
            if on_sample is not None:
                on_sample(sample)
            if realtime:
                next_t += self.dt
                delay = next_t - time.perf_counter()
                if delay > 0:
                    time.sleep(delay)
