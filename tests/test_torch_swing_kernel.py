"""The swing law's CUDA kernel (``csrc/swing_torques.cu``, launched by
``control/swing.swing_torques`` on CUDA tensors, which must be float32).

On the CPU: the controller reads the kernel-backed law; off the card the
law is ``swing_torques_plain`` bit for bit and launches nothing; and the
kernel's own source, compiled for the CPU with g++ and run a thread per
CUDA thread (``tests/cuda_emulation.h``), agrees with the float64 plain
law on every state kind of ``chip_smoke.swing_states``: the controller's
inputs at the last substep of the sweep's first planner tick, knees within
1e-3 rad of straight, joint speeds up to 20 rad/s and tilted bases. The
bound is ``chip_smoke.swing_gates``': twice the float32 plain law's own
distance from the float64 one on the same inputs, or 2e-4 N·m. Measured
here (seed 11, B = 8; largest torque, emulated kernel's distance, float32
plain law's):

    sweep   17.4 N·m    1.04e-05  1.25e-05
    knee   266.5 N·m    6.95e-04  6.11e-04
    fast   932.9 N·m    1.46e-04  2.30e-04
    tilted 191.3 N·m    4.12e-05  4.12e-05

The kernel's inverse dynamics (recursive Newton-Euler) is held to
``tests/test_swing_dynamics_oracle.py``'s float64 Lagrangian oracle on its
random states: within 2e-6 of the largest torque plus 1 (measured 1.5e-7;
the JAX package's float32 dynamics is held to 5e-4 there).

On the card (the tests marked ``cuda``; they skip without one) the kernel
is held against the float64 plain law at B = 1 and 32768 on every kind;
two launches equal bit for bit; the closed loop's prepare stage replayed
from its CUDA graph equals the eager stage bit for bit and counts one
launch of B scenarios a replay; a rollout launches the kernel once a
substep; the build spills nothing; float64 card tensors are refused.
Where the JAX package is absent:

    python3 -m pytest --noconftest -m cuda tests/test_torch_swing_kernel.py
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from chip_smoke import (
    SWING_KINDS, StageTap, as_float64, hold_swing, swing_gates,
    swing_readings, swing_states,
)
from quadruped_locomotion_tpu_torch import sweep
from quadruped_locomotion_tpu_torch.control import locomotion
from quadruped_locomotion_tpu_torch.control import swing
from quadruped_locomotion_tpu_torch.rollout import closed_loop as cl
from quadruped_locomotion_tpu_torch.types import GRAVITY, RobotModel
from quadruped_locomotion_tpu_torch.utils.cuda_build import pack_model
from quadruped_locomotion_tpu_torch.utils.logging import counters

ROOT = Path(__file__).resolve().parent.parent
COUNTERS = ("swing.kernel_launches", "swing.kernel_instances")


def _counted():
    return tuple(counters[k] for k in COUNTERS)


def test_the_controller_reads_the_kernel_backed_law():
    assert locomotion.swing_torques is swing.swing_torques


def test_off_the_card_the_law_is_the_plain_law():
    inputs = swing_states("fast", 8, "cpu", seed=5)
    before = _counted()
    assert torch.equal(swing.swing_torques(*inputs),
                       swing.swing_torques_plain(*inputs))
    assert _counted() == before


def test_the_kernel_inputs_flatten_the_leading_dims():
    """An unbatched state (the single-leg controller's) and a (2, 3) batch
    come out as B = 1 and 6 rows of contiguous (B, 4) / (B, 4, 3) inputs,
    which the kernel's argument check accepts."""
    model, gains, state, p, v, a = swing_states("tilted", 6, "cpu", seed=2)
    one = state.replace(q=state.q[0], qd=state.qd[0],
                        base=state.base.replace(
                            quaternion=state.base.quaternion[0]))
    assert swing.KERNEL.check(*swing.kernel_inputs(
        model, gains, one, p[0], v[0], a[0]).values()) == 1
    grid = state.replace(q=state.q.reshape(2, 3, 4, 3),
                         qd=state.qd.reshape(2, 3, 4, 3),
                         base=state.base.replace(
                             quaternion=state.base.quaternion.reshape(2, 3, 4)))
    ins = swing.kernel_inputs(model, gains, grid, p.reshape(2, 3, 4, 3),
                              v.reshape(2, 3, 4, 3), a.reshape(2, 3, 4, 3))
    assert swing.KERNEL.check(*ins.values()) == 6
    assert torch.equal(ins["q"], state.q)


def test_the_counts_are_the_kernels_arithmetic():
    """~1,000 flop a leg and 304 bytes a scenario: at B = 32768 the launch
    is bound by its bytes."""
    assert swing.swing_flops() == 999
    assert swing.swing_bytes(1) == 4 * (126 + 76)
    assert 4 * 32768 * swing.swing_flops() / 67e12 < (
        swing.swing_bytes(32768) / 3.35e12)


# ---------------------------------------------------------------------------
# the kernel's source on the CPU
# ---------------------------------------------------------------------------

_EMULATED = """
#include "cuda_emulation.h"
#include "swing_torques.cu"
extern "C" void swing_torques_emulated(
    const float* model, const float* kp, const float* kd, const float* quat,
    const float* q, const float* qd, const float* p_des, const float* v_des,
    const float* a_des, float* tau, int B, float gravity, float damping,
    float feedforward) {
  emulate_launch((B + SCENARIOS - 1) / SCENARIOS, THREADS, [&] {
    swing_torques_kernel(model, kp, kd, quat, q, qd, p_des, v_des, a_des, tau,
                         B, gravity, damping, feedforward);
  });
}
// the kernel's inverse dynamics of n legs: leg_chain, leg_motion and rnea
extern "C" void swing_rnea_emulated(const float* model, const float* q,
                                    const float* qd, const float* qdd,
                                    const float* g, float* tau, int n) {
  const Model& m = *reinterpret_cast<const Model*>(model);
  for (int k = 0; k < n; ++k) {
    Chain c;
    leg_chain(m, q + 3 * k, c);
    Motion v;
    leg_motion(c, qd + 3 * k, v);
    rnea(m, c, v, qdd + 3 * k, g + 3 * k, tau + 3 * k);
  }
}
"""


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """The kernel's source built for the CPU by g++ (-O1, C++20 for
    std::barrier) against ``tests/cuda_emulation.h``."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel's source for the CPU")
    d = tmp_path_factory.mktemp("swing_emulated")
    (d / "emulated.cpp").write_text(_EMULATED)
    so = d / "emulated.so"
    proc = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-pthread", "-shared", "-fPIC",
         "-I", str(ROOT / "tests"), "-I", str(swing.SOURCE.parent),
         "-o", str(so), str(d / "emulated.cpp")],
        capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    lib = ctypes.CDLL(str(so))
    lib.swing_torques_emulated.argtypes = [ctypes.c_void_p] * 10 + [
        ctypes.c_int] + [ctypes.c_float] * 3
    lib.swing_torques_emulated.restype = None
    lib.swing_rnea_emulated.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int]
    lib.swing_rnea_emulated.restype = None
    return lib


def _emulated_law(lib, inputs) -> torch.Tensor:
    ins = swing.kernel_inputs(*inputs)
    B = swing.KERNEL.check(*ins.values())
    tau = torch.empty((B, 4, 3))
    lib.swing_torques_emulated(*(t.data_ptr() for t in ins.values()),
                               tau.data_ptr(), B, GRAVITY, swing.DAMPING,
                               swing.FEEDFORWARD)
    return tau


@pytest.mark.parametrize("kind", SWING_KINDS)
def test_the_kernel_source_on_the_cpu_matches_the_float64_law(emulated,
                                                              kind):
    """Eight scenarios (32 legs, a quarter block) of each state kind."""
    inputs = swing_states(kind, 8, "cpu", seed=11)
    got = _emulated_law(emulated, inputs)
    swing_gates(swing_readings(got, inputs), kind)


def test_the_kernel_inverse_dynamics_matches_the_lagrangian_oracle(emulated):
    """The recursive Newton-Euler term alone against the float64
    Euler-Lagrange oracle of ``tests/test_swing_dynamics_oracle.py``: its
    20 random states (joint speeds to 6 rad/s, accelerations to 40
    rad/s²) on each of the 4 legs' hip gravity."""
    from test_swing_dynamics_oracle import _rand_states, torch_inverse_dynamics

    model = RobotModel.simpledog("cpu")
    q, qd, qdd = _rand_states(20, seed=1)
    g_base = np.array([0.0, 0.0, -GRAVITY])
    for leg in range(4):
        g_hip = model.hip_rot[leg].double().numpy().T @ g_base
        # the arrays stay referenced while the library reads them
        ins = [pack_model(model)] + [
            torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32)
            for a in (q, qd, qdd, np.broadcast_to(g_hip, q.shape))]
        tau = torch.empty((len(q), 3))
        emulated.swing_rnea_emulated(*(t.data_ptr() for t in ins),
                                     tau.data_ptr(), len(q))
        for i in range(len(q)):
            _, want = torch_inverse_dynamics(q[i], qd[i], qdd[i], g_hip)
            err = np.abs(tau[i].double().numpy() - want).max()
            assert err / (1.0 + np.abs(want).max()) < 2e-6, (leg, i, err)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 32768])
@pytest.mark.parametrize("kind", SWING_KINDS)
def test_the_kernel_matches_the_float64_law(cuda_device, kind, batch):
    """One launch counted as one of B scenarios, two launches equal bit for
    bit, within the gates of the float64 plain law (``hold_swing``)."""
    hold_swing(swing_states(kind, batch, cuda_device, seed=batch), kind)


@pytest.mark.cuda
def test_on_the_card_float64_is_refused(cuda_device):
    """No fall-back to the plain law on the card: the float64 plain law is
    called by name."""
    inputs = swing_states("fast", 4, cuda_device)
    before = _counted()
    with pytest.raises(ValueError, match="float32"):
        swing.swing_torques(*(as_float64(x) for x in inputs))
    assert _counted() == before


@pytest.mark.cuda
def test_two_launches_are_equal_bit_for_bit(cuda_device):
    inputs = swing_states("tilted", 4096 + 3, cuda_device)
    assert torch.equal(swing.swing_torques(*inputs),
                       swing.swing_torques(*inputs))


@pytest.mark.cuda
def test_the_replayed_prepare_stage_equals_the_eager_stage(cuda_device):
    """The prepare stage of 16 config-5 scenarios at the last substep of a
    planner tick, replayed from its CUDA graph: its outputs equal the eager
    stage's bit for bit, and each replay counts one swing launch of 16
    scenarios (the capture none)."""
    sc = sweep.build_scenarios(16, seed=3, device=cuda_device)
    with StageTap(cl, "prepare") as tap:
        sweep.run(sc, 1)
    bound, args = tap.last
    stage = cl.STAGES["prepare"]
    stage.graphs.clear()
    stage(bound, *args)  # a warm-up, the capture and a replay
    (graph,) = stage.graphs.values()
    assert tuple(graph.counted[k] for k in COUNTERS) == (1, 16)
    before = _counted()
    got = stage(bound, *args)
    assert _counted() == (before[0] + 1, before[1] + 16)
    want = stage.fn(*bound, *args)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
def test_a_rollout_launches_the_kernel_once_a_substep(cuda_device):
    """Planner ticks of 16 config-5 scenarios: after the first tick, whose
    capture of the prepare stage launches once more (its eager warm-up),
    4 swing launches a tick, each over the 16 scenarios."""
    sc = sweep.build_scenarios(16, seed=3, device=cuda_device)
    model, params, gait_params, ls, command = sc.rollout_args()

    def tick(ls):
        return cl.planner_tick(model, params, gait_params, ls, command,
                               qp_iters=30, terrain=sc.terrain)[0]

    ls = tick(ls)
    before = _counted()
    for _ in range(2):
        ls = tick(ls)
    steps = 2 * cl.CONTROL_SUBSTEPS
    assert _counted() == (before[0] + steps, before[1] + 16 * steps)


@pytest.mark.cuda
def test_the_build_spills_nothing(cuda_device):
    """ptxas's report: no spill stores or loads."""
    from quadruped_locomotion_tpu_torch.utils.cuda_build import ptxas_report

    report = ptxas_report(swing.KERNEL.build().log)
    assert report["spill_store_bytes"] == 0 and report["spill_load_bytes"] == 0
