"""Closed-loop locomotion on estimated state: plant → sensors → EKF →
controller, batched over scenarios (≙ ``quadruped_locomotion_tpu/rollout/
estimated_loop.py``).

The gait engine and the balance controller never see the plant's ground
truth: they run on the error-state EKF (``control/state_estimator.py``),
which sees only simulated sensors:

* body-frame gyro and accelerometer with white noise and a constant bias,
  synthesized from the plant's true base motion;
* joint encoders (position and velocity) with white noise;
* binary foot-contact switches.

Per 400 Hz control substep: measure → contact FSM (slip detection from
measured kinematics) → controller on the estimate, whose QP is the
generic IPM (``ops/qp.py::solve_qp``, as the reference's single-scenario
tick; the force-distribution kernel is not on this path) → plant step →
EKF predict (IMU) + update (stance-foot kinematics). The 100 Hz gait tick
also runs on the estimate.

Sensor noise comes from the state's ``torch.Generator`` on the loop's
device (JAX's key streams cannot be reproduced; with
``SensorParams.ideal()`` every draw is multiplied by zero).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..control import state_estimator as se
from ..control.contact_fsm import apply_swing_reflexes, fsm_step
from ..control.locomotion import ControllerParams, locomotion_update
from ..control.swing import joint_pd_gravity_torques
from ..gait import gait_generator as gg
from ..gait.phase import GaitParams
from ..model.kinematics import mv
from ..types import (
    GRAVITY, BaseState, RobotModel, TensorStruct, full_f32_matmuls,
    resolve_device,
)
from ..utils.rotations import matrix_from_quat
from . import articulated as artlib
from . import simulator as simlib
from .closed_loop import (
    CONTROL_DT, CONTROL_SUBSTEPS, PLANNER_DT, Command, LocomotionState,
    init_locomotion, measured_foot_speed_tangential,
)

PLANTS = {"articulated": artlib.step, "massless": simlib.step}


@dataclass
class SensorParams(TensorStruct):
    """White-noise standard deviations and constant biases of the
    simulated sensors."""

    gyro_noise: torch.Tensor  # rad/s per sample
    accel_noise: torch.Tensor  # m/s² per sample
    encoder_noise: torch.Tensor  # rad
    encoder_vel_noise: torch.Tensor  # rad/s
    gyro_bias: torch.Tensor  # (3,) rad/s
    accel_bias: torch.Tensor  # (3,) m/s²

    @classmethod
    def realistic(cls, device=None, dtype=torch.float32) -> "SensorParams":
        """Consumer-grade MEMS IMU + 16-bit encoders at 400 Hz."""
        return cls._make(device, dtype, 0.02, 0.4, 1e-3, 1e-2,
                         [0.002, -0.003, 0.001], [0.05, -0.03, 0.08])

    @classmethod
    def ideal(cls, device=None, dtype=torch.float32) -> "SensorParams":
        return cls._make(device, dtype, 0.0, 0.0, 0.0, 0.0, [0.0] * 3,
                         [0.0] * 3)

    @classmethod
    def _make(cls, device, dtype, gyro, accel, enc, enc_vel, gyro_bias,
              accel_bias):
        dev = resolve_device(device)
        f = lambda x: torch.as_tensor(x, dtype=dtype, device=dev)  # noqa: E731
        return cls(gyro_noise=f(gyro), accel_noise=f(accel),
                   encoder_noise=f(enc), encoder_vel_noise=f(enc_vel),
                   gyro_bias=f(gyro_bias), accel_bias=f(accel_bias))


@dataclass
class EstimatedLoopState(TensorStruct):
    loop: LocomotionState
    est: se.EstimatorState
    gyro: torch.Tensor  # (B,3) latest gyro sample (the controller's ω)
    generator: torch.Generator  # sensor noise, on the loop's device


def init_estimated(
    model: RobotModel,
    gait_params: GaitParams,
    batch: int,
    seed: int = 0,
    gait_type: int = 0,
    init_pos_err: float = 0.0,
    device=None,
) -> EstimatedLoopState:
    """Standing starts of ``batch`` scenarios in gait ``gait_type`` on
    ``device`` (default CUDA; raises where it is absent), the EKF at the
    true pose (plus ``init_pos_err`` along (1, -1, 0.5)) and a noise
    generator seeded with ``seed`` on that device."""
    dev = resolve_device(device)
    ls = init_locomotion(model, gait_params, batch, gait_type=gait_type,
                         device=dev)
    truth = ls.sim.robot.base
    pos0 = truth.position + init_pos_err * truth.position.new_tensor(
        [1.0, -1.0, 0.5])
    est = se.init_state(pos0, truth.quaternion, ls.sim.feet_world,
                        pos_std=0.02, foot_std=1e-3)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return EstimatedLoopState(loop=ls, est=est,
                              gyro=torch.zeros_like(pos0), generator=gen)


def _estimated_robot(sim_robot, est, gyro, q_meas, qd_meas):
    """The state the controller believes: EKF base + measured joints."""
    base = BaseState(position=est.position, quaternion=est.quaternion,
                     linear_velocity=est.velocity, angular_velocity=gyro)
    return sim_robot.replace(base=base, q=q_meas, qd=qd_meas)


def planner_tick_estimated(
    model: RobotModel,
    params: ControllerParams,
    gait_params: GaitParams,
    est_params: se.EstimatorParams,
    sensors: SensorParams,
    els: EstimatedLoopState,
    command: Command,
    qp_iters: int = 15,
    plant: str = "articulated",
    friction_mu: float | None = None,
):
    """One 100 Hz planner tick + 4 estimated control/physics substeps.
    Returns (new state, (max QP KKT over the substeps (B,), the last
    substep's FSM leg states (B,4)))."""
    plant_step = PLANTS[plant]
    plant_kwargs = ({"friction_mu": friction_mu}
                    if friction_mu is not None and plant == "articulated"
                    else {})
    ls = els.loop
    q0 = ls.sim.robot.q
    gen = els.generator

    def noise(*shape):
        return torch.randn(shape, generator=gen, dtype=q0.dtype,
                           device=q0.device)

    B = q0.shape[0]
    # gait tick on the estimate: EKF base, measured joints, EKF feet
    q_meas0 = q0 + sensors.encoder_noise * noise(B, 4, 3)
    robot_hat = _estimated_robot(ls.sim.robot, els.est, els.gyro, q_meas0,
                                 ls.sim.robot.qd)
    gait2, support, (pos_w, vel_w, acc_w), target, normals = gg.advance(
        model, ls.gait, robot_hat, els.est.foot_positions, gait_params,
        command.linear_velocity, command.yaw_rate, PLANNER_DT)
    sw_norm = gait2.phase.swing_phase / torch.clamp(
        gait_params.t_swing[..., None], min=1e-6)
    st_norm = gait2.phase.stance_phase / torch.clamp(
        gait_params.t_stance[..., None], min=1e-6)
    g_vec = q0.new_tensor([0.0, 0.0, -GRAVITY])

    sim, fsm_state, est = ls.sim, ls.fsm, els.est
    kkt = gyro = leg_state = None
    for _ in range(CONTROL_SUBSTEPS):
        # measure
        q_meas = sim.robot.q + sensors.encoder_noise * noise(B, 4, 3)
        qd_meas = sim.robot.qd + sensors.encoder_vel_noise * noise(B, 4, 3)
        gyro = (sim.robot.base.angular_velocity + sensors.gyro_bias
                + sensors.gyro_noise * noise(B, 3))
        contact = simlib.contact_sensor(sim)

        # reconcile and control on the estimate
        robot_meas = _estimated_robot(sim.robot, est, gyro, q_meas, qd_meas)
        fsm_state, fsm = fsm_step(
            fsm_state, support, contact, sw_norm, st_norm, q_meas,
            foot_speed_tangential=measured_foot_speed_tangential(
                model, robot_meas))
        pos_r, vel_r, acc_r = apply_swing_reflexes(
            pos_w, vel_w, acc_w, est.foot_positions, fsm)
        state = robot_meas.replace(support=fsm.support, surface_normal=normals)
        tau, diag = locomotion_update(model, params, state, target, pos_r,
                                      vel_r, acc_r, qp_iters=qp_iters)
        tau_freeze = joint_pd_gravity_torques(
            model, state, fsm.q_freeze, torch.zeros_like(fsm.q_freeze))
        tau = torch.where(fsm.freeze[..., None], tau_freeze, tau)

        # plant (ground truth)
        v1 = sim.robot.base.linear_velocity
        rot1 = matrix_from_quat(sim.robot.base.quaternion)
        sim2 = plant_step(model, sim, tau, CONTROL_DT, support=fsm.support,
                          **plant_kwargs)

        # IMU over the interval, then the EKF
        a_w = (sim2.robot.base.linear_velocity - v1) / CONTROL_DT
        accel = (mv(rot1.mT, a_w - g_vec) + sensors.accel_bias
                 + sensors.accel_noise * noise(B, 3))
        q_meas2 = sim2.robot.q + sensors.encoder_noise * noise(B, 4, 3)
        est = se.step(model, est_params, est, gyro, accel, q_meas2,
                      simlib.contact_sensor(sim2), CONTROL_DT)
        sim = sim2
        k = diag.distribution.qp_solution.kkt_error
        kkt = k if kkt is None else torch.maximum(kkt, k)
        leg_state = fsm.leg_state
    els2 = EstimatedLoopState(
        loop=LocomotionState(sim=sim, gait=gait2, fsm=fsm_state), est=est,
        gyro=gyro, generator=gen)
    return els2, (kkt, leg_state)


def rollout_estimated(
    model: RobotModel,
    params: ControllerParams,
    gait_params: GaitParams,
    est_params: se.EstimatorParams,
    sensors: SensorParams,
    els0: EstimatedLoopState,
    command: Command,
    planner_steps: int,
    qp_iters: int = 15,
    plant: str = "articulated",
    friction_mu: float | None = None,
    device=None,
):
    """Estimated closed-loop rollout on ``device`` (default CUDA; raises
    where it is absent). Returns (final state, telemetry): (T, B, ...)
    tensors per planner tick, with the truth-vs-estimate errors
    ``pos_err`` and ``vel_err`` (T, B)."""
    dev = resolve_device(device)
    if plant not in PLANTS:
        raise ValueError(f"unknown plant {plant!r}")
    if els0.generator.device.type != dev.type:
        raise ValueError(f"the state's generator is on "
                         f"{els0.generator.device}, the loop on {dev}")
    full_f32_matmuls()
    model, params, gait_params, est_params, sensors, els, command = (
        o.to(dev) for o in (model, params, gait_params, est_params, sensors,
                            els0, command))
    gait_params = gait_params.per_scenario(els.gyro.shape[0])
    keys = ("base_position", "base_quaternion", "est_position",
            "est_velocity", "true_velocity", "pos_err", "vel_err",
            "feet_world", "leg_state", "qp_kkt")
    tel = {k: [] for k in keys}
    for _ in range(planner_steps):
        els, (kkt, leg_state) = planner_tick_estimated(
            model, params, gait_params, est_params, sensors, els, command,
            qp_iters=qp_iters, plant=plant, friction_mu=friction_mu)
        truth = els.loop.sim.robot.base
        row = {
            "base_position": truth.position,
            "base_quaternion": truth.quaternion,
            "est_position": els.est.position,
            "est_velocity": els.est.velocity,
            "true_velocity": truth.linear_velocity,
            "pos_err": torch.linalg.norm(els.est.position - truth.position,
                                         dim=-1),
            "vel_err": torch.linalg.norm(
                els.est.velocity - truth.linear_velocity, dim=-1),
            "feet_world": els.loop.sim.feet_world,
            "leg_state": leg_state,
            "qp_kkt": kkt,
        }
        for k in keys:
            tel[k].append(row[k])
    return els, {k: torch.stack(v) for k, v in tel.items()}
