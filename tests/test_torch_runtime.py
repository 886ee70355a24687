"""The port's runtime layer (``quadruped_locomotion_tpu_torch/runtime/``) and
its balance tick (``control/balance_controller.balance_update``) against
the JAX package's ``runtime/`` and ``control/balance_controller.py``.

The JAX outputs are the committed ``runtime/`` section of
``tests/data/torch_port_slice6_refs.npz``
(``scripts/make_torch_port_references.py --file slice6``): the JAX
``ControllerManager`` + ``SimHardware`` + ``BalanceStandController``
standing from the 0.4 m stance for 400 ticks (each tick's sample,
torques and warm QP iterates), ``balance_update`` on five of those
samples, and the single-leg and freeze controllers' torques on four.
Nothing here runs JAX.

On the CPU every tick runs eagerly (the card captures the same functions
as CUDA graphs; ``chip_smoke.py`` phase 13 holds the replays to the eager
tick bit for bit). Tolerances are stated beside each check.
"""

from __future__ import annotations

import json
import multiprocessing as mp
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from quadruped_locomotion_tpu.runtime import hal as jhal
from quadruped_locomotion_tpu_torch.control.balance_controller import balance_update
from quadruped_locomotion_tpu_torch.control.force_distribution import build_qp
from quadruped_locomotion_tpu_torch.control.vmc import compute_virtual_wrench
from quadruped_locomotion_tpu_torch.runtime import hal, manager as mgr
from quadruped_locomotion_tpu_torch.runtime import realtime_bench as rb
from quadruped_locomotion_tpu_torch.types import (
    BaseTarget, CfdParams, RobotModel, VmcGains,
)

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "scripts"))
import make_torch_port_references as make_refs  # noqa: E402

torch.set_num_threads(1)

WRENCH = dict(rtol=1e-5, atol=1e-3)  # as tests/test_torch_control.py
TORQUE = dict(rtol=1e-5, atol=1e-4)
# The W = 1e-4 flat valley (ROADMAP.md §3): two float32 solves of the same
# problem pin forces 0.1-0.5 N apart, so the balance torques are held to
# 1 N·m (observed ≤ 0.74 N·m) and the QP to its objective and KKT.
BALANCE_TORQUE_ATOL = 1.0
OBJECTIVE_GAP = 1e-4  # relative, on the same formed problem (obs. ≤ 5.8e-6)


@pytest.fixture(scope="module")
def refs():
    with np.load(make_refs.SLICE6_OUT) as f:
        return {k[len("runtime/"):]: f[k] for k in f.files}


@pytest.fixture(scope="module")
def model():
    return RobotModel.simpledog("cpu")


def _target(refs) -> BaseTarget:
    return BaseTarget(**{k: torch.from_numpy(refs[f"standing/target/{k}"])
                         for k in ("position", "quaternion", "linear_velocity",
                                   "angular_velocity")})


def _sample(vec) -> hal.RobotSample:
    return hal.RobotSample.unpack(np.asarray(vec, np.float32))


# --------------------------------------------------------------------------
# wire layouts and the shared-memory ring
# --------------------------------------------------------------------------


def test_wire_layouts_match_the_reference():
    assert (hal.SAMPLE_FLOATS, hal.COMMAND_FLOATS) == (
        jhal.SAMPLE_FLOATS, jhal.COMMAND_FLOATS) == (55, 14)
    fields = dict(
        base_position=np.array([1.0, 2, 3], np.float32),
        base_quaternion=np.array([1.0, 0, 0, 0], np.float32),
        base_linear_velocity=np.zeros(3, np.float32),
        base_angular_velocity=np.ones(3, np.float32),
        q=np.arange(12, dtype=np.float32).reshape(4, 3),
        qd=np.zeros((4, 3), np.float32), tau=np.ones((4, 3), np.float32),
        contacts=np.array([True, False, True, True]), estop=False, time=1.25)
    vec = hal.RobotSample(**fields).pack()
    np.testing.assert_array_equal(vec, jhal.RobotSample(**fields).pack())
    back = hal.RobotSample.unpack(vec)
    np.testing.assert_array_equal(back.q, fields["q"])
    np.testing.assert_array_equal(back.contacts, fields["contacts"])
    assert back.time == 1.25 and back.estop is False
    tau = np.arange(12, dtype=np.float32).reshape(4, 3)
    cmd = hal.pack_command(tau, mode=3, estop=True)
    np.testing.assert_array_equal(cmd, jhal.pack_command(tau, 3, True))
    t2, mode, estop = hal.unpack_command(cmd)
    np.testing.assert_array_equal(t2, tau)
    assert mode == 3 and estop


def _native_status():
    """``git status --porcelain native/`` (in a git checkout) and the
    names, sizes and modification times of the files in native/."""
    files = sorted((f.name, f.stat().st_size, f.stat().st_mtime_ns)
                   for f in (ROOT / "native").iterdir())
    if not (ROOT / ".git").exists():
        return files
    return files, subprocess.run(["git", "status", "--porcelain", "native/"],
                                 cwd=ROOT, capture_output=True, text=True,
                                 check=True).stdout


def _writer_proc(name, count):
    from quadruped_locomotion_tpu_torch.runtime.shm import ShmRing

    ring = ShmRing.open(name)
    for i in range(count):
        ring.push(np.full(4, i, np.float32))
    ring.close()


@pytest.mark.parametrize("where", ["in_process", "cross_process"])
def test_shm_ring_push_pop_latest(where):
    """The port's binding of native/shm_ring.c, built into the package's
    build/ directory: the reference's own build output and source stay as
    they were."""
    from quadruped_locomotion_tpu_torch.runtime.shm import BUILD_DIR, ShmRing, build_library

    before = _native_status()
    name = f"/qlt_torch_test_{where}_{os.getpid()}"
    ring = ShmRing.create(name, slot_floats=8, n_slots=16)
    try:
        assert ring.pop_latest(8) is None
        if where == "in_process":
            for i in range(40):  # laps the 16-slot ring
                ring.push(np.full(8, i, np.float32))
            idx, vec = ring.pop_latest(8)
            assert idx == 39 and ring.head == 40
            np.testing.assert_array_equal(vec, np.full(8, 39, np.float32))
            assert ring.read_at(39, 8) is not None
            assert ring.read_at(2, 8) is None  # lapped
        else:
            proc = mp.get_context("spawn").Process(target=_writer_proc,
                                                   args=(name, 500))
            proc.start()
            proc.join(timeout=120)
            assert not proc.is_alive() and proc.exitcode == 0
            idx, vec = ring.pop_latest(4)
            assert idx == 499
            np.testing.assert_array_equal(vec, np.full(4, 499, np.float32))
    finally:
        ring.close()
        ShmRing.unlink(name)
    assert build_library().parent == BUILD_DIR
    assert _native_status() == before


# --------------------------------------------------------------------------
# the balance tick
# --------------------------------------------------------------------------


@pytest.mark.parametrize("tick", make_refs.RT_BALANCE_TICKS)
def test_balance_update_matches_jax(refs, model, tick):
    """Tick 0: the cold solve (15 iterations, full polish); later ticks:
    warm from JAX's previous (x, z), 8 iterations, light polish. The
    wrench at WRENCH, the formed problem at TORQUE, the QP's objective on
    JAX's formed problem within OBJECTIVE_GAP of JAX's, its KKT at most
    2x JAX's (or below 1e-6; at tick 399 both warm solves end near KKT 3),
    the torques within BALANCE_TORQUE_ATOL."""
    p = f"balance/{tick}/"
    vec = torch.from_numpy(refs["standing/samples"][tick])
    cold = tick == 0
    warm = None if cold else tuple(
        torch.from_numpy(refs[f"standing/warm_{k}"][tick - 1]) for k in "xz")
    state = mgr._robot_state_from_vec(vec)
    gains, cfd, target = VmcGains.gazebo_defaults("cpu"), CfdParams.defaults("cpu"), _target(refs)
    tau, diag = balance_update(model, gains, cfd, state, target,
                               qp_iters=15 if cold else 8, warm=warm,
                               polish="full" if cold else "light")
    np.testing.assert_allclose(diag.virtual_force.numpy(), refs[p + "vf"], **WRENCH)
    np.testing.assert_allclose(diag.virtual_torque.numpy(), refs[p + "vt"], **WRENCH)
    vf, vt = compute_virtual_wrench(model, gains, state, target)
    for name, got in zip("A b S W D d".split(), build_qp(model, cfd, state, vf, vt)):
        np.testing.assert_allclose(got.numpy(), refs[p + name], **TORQUE)

    A, b, S, W = (refs[p + k].astype(np.float64) for k in "AbSW")
    obj = lambda x: ((A @ x - b) ** 2 * S).sum() + (x * x * W).sum()  # noqa: E731
    sol = diag.distribution.qp_solution
    x = sol.x.numpy().astype(np.float64)
    ref = obj(refs[p + "x"].astype(np.float64))
    assert abs(obj(x) - ref) / (1.0 + abs(ref)) < OBJECTIVE_GAP
    assert float(sol.kkt_error) <= max(1e-6, 2.0 * float(refs[p + "kkt"]))
    np.testing.assert_allclose(tau.numpy(), refs[p + "tau"], rtol=0,
                               atol=BALANCE_TORQUE_ATOL)
    assert torch.isfinite(tau).all() and tau.abs().max() <= 300.0


@pytest.mark.parametrize("name", ["single_leg", "freeze"])
def test_hold_controllers_match_jax(refs, model, name):
    """Started on tick 50's sample (single leg: LF toward its start foot
    position + 5 cm forward and up), updated on ticks 50-53: torques at
    TORQUE."""
    samples = refs["standing/samples"]
    start = _sample(samples[make_refs.RT_HOLD_TICKS[0]])
    if name == "single_leg":
        ctrl = mgr.SingleLegController(model, legs=(0,), device="cpu")
        ctrl.start(start)
        ctrl.set_targets(refs["single_leg/p_des"])
    else:
        ctrl = mgr.FreezeController(model, device="cpu")
        ctrl.start(start)
    got = np.stack([ctrl.update(_sample(samples[t]))
                    for t in make_refs.RT_HOLD_TICKS])
    np.testing.assert_allclose(got, refs[f"{name}/tau"], **TORQUE)


# --------------------------------------------------------------------------
# the manager against SimHardware on the CPU
# --------------------------------------------------------------------------


def _manager(model, height=0.4):
    hw = hal.SimHardware(model, height=height, device="cpu")
    m = mgr.ControllerManager(hw, model)
    m.register(mgr.BalanceStandController(model, device="cpu"))
    m.register(mgr.FreezeController(model, device="cpu"))
    m.register(mgr.JointTorqueController())
    m.register(mgr.SingleLegController(model, legs=(0,), device="cpu"))
    return m


@pytest.fixture(scope="module")
def standing(model):
    """400 ticks (1 s at 400 Hz) of standing balance from the 0.4 m stance:
    each tick's sample and the final one."""
    m = _manager(model)
    m.switch("base_balance_controller")
    samples = []
    m.run(make_refs.RT_TICKS, on_sample=lambda s: samples.append(s.pack()))
    return m, np.stack(samples), m.hw.read_packed()


def test_standing_balance_matches_jax_golden(refs, standing):
    """Base positions against the JAX golden: within 1e-6 m over the first
    20 ticks (where both warm chains agree); within 1e-2 m after, because
    the reference's warm 8-iteration solves jump along the flat valley
    (its torques reach 100-300 N·m at ticks 23-28 of the golden and move
    the base by up to 5 mm; the port's do not). Then the bounds of
    tests/test_runtime.py::test_balance_stand_holds_height."""
    m, samples, final = standing
    golden = refs["standing/samples"]
    dpos = np.abs(samples[:, 0:3] - golden[:, 0:3]).max(-1)
    assert dpos[:20].max() < 1e-6, dpos[:20]
    assert dpos.max() < 1e-2, dpos.max()
    assert abs(final[2] - 0.4) < 0.02
    assert np.linalg.norm(final[7:10]) < 0.2
    assert np.isfinite(samples).all() and m.kept_previous == 0


def test_switch_and_estop(model):
    m = _manager(model)
    m.switch("base_balance_controller")
    m.run(4)
    m.switch("freeze_controller")  # re-inits from the current state
    m.run(4)
    m.estop()
    m.run(3)
    s = m.hw.read()
    assert m.estopped and s.estop
    np.testing.assert_array_equal(s.tau, 0.0)  # zero torque was applied


def test_failed_update_keeps_previous_torques(model):
    m = _manager(model)
    m.switch("base_balance_controller")
    m.run(2)
    prev = m._last_tau.copy()

    class Broken(mgr.Controller):
        name = "broken"

        def update(self, sample):
            raise RuntimeError("boom")

    class NotFinite(mgr.Controller):
        name = "not_finite"

        def update(self, sample):
            return np.full((4, 3), np.nan, np.float32)

    for ctrl in (Broken(), NotFinite()):
        m.register(ctrl)
        m.active = ctrl
        m.tick()
        np.testing.assert_array_equal(m._last_tau, prev)
        np.testing.assert_array_equal(m.hw.read().tau, prev)
    assert m.kept_previous == 2
    assert m.first_failure == dict(tick=2, controller="broken",
                                   error="RuntimeError: boom",
                                   sample_finite=True)


def test_joint_torque_forwarding(model):
    m = _manager(model)
    jt = m.controllers["joint_torque_controller"]
    jt.command = np.full((4, 3), 5.0, np.float32)
    m.switch("joint_torque_controller")
    m.tick()
    np.testing.assert_allclose(m._last_tau, 5.0)


def test_two_process_loop_on_the_cpu():
    """scripts/measure_realtime_torch.py with the controller and the bus on
    the CPU, 20 nominal ticks at 400 Hz, e-stop after 10 (the eager CPU
    plant steps at ~10 Hz, so no rate is gated here): the bus ran and
    latched the e-stop, the controller ticked and read the latch back, no
    tick kept previous torques, and the rings are gone. The run's own
    time limit is the subprocess timeout."""
    proc = subprocess.run(
        [sys.executable, str(ROOT / "scripts" / "measure_realtime_torch.py"),
         "0.05", "400", "--device", "cpu", "--bus-device", "cpu",
         "--estop-at-s", "0.025"],
        capture_output=True, text=True, timeout=240, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    rep = json.loads(proc.stdout.strip().splitlines()[-1])
    assert rep["bus_ticks"] > 0 and "bus_error" not in rep, rep
    assert rep["bus_estopped"] and rep["controller_ticks"] >= 10, rep
    assert rep["estop_latency_s"] is not None, rep
    assert rep["kept_previous"] == 0 and rep["first_failure"] is None, rep
    assert rep["samples_finite"], rep
    assert (rep["device"], rep["bus_device"]) == ("cpu", "cpu")
    assert rep["plant_dt"] == 1.0 / 400 and rep["bus_held_ticks"] >= 0, rep
    assert rep["prefix"].startswith(rb.BUS_PREFIX + "_")  # + the pid
    assert not list(Path("/dev/shm").glob(rep["prefix"].strip("/") + "_*"))


def test_entry_points_default_to_cuda(monkeypatch, model):
    """device=None means CUDA; without it the runtime raises instead of
    falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [
        lambda: hal.SimHardware(model),
        lambda: mgr.BalanceStandController(model),
        lambda: mgr.SingleLegController(model),
        lambda: mgr.FreezeController(model),
        lambda: rb.measure(duration_s=0.01),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


@pytest.mark.slow
def test_references_match_live_jax(refs):
    """The committed JAX outputs are what the JAX package computes now."""
    live = make_refs.runtime_references()
    assert set(live) == set(refs)
    for k, v in live.items():
        np.testing.assert_array_equal(np.asarray(v), refs[k], err_msg=k)
