"""The articulated plant's CUDA kernel (``csrc/articulated_step.cu``,
launched by ``rollout/articulated.step`` on CUDA tensors, which must be
float32).

On the CPU: the closed loop reads the kernel-backed ``step``; off the card
``step`` is ``step_plain`` bit for bit and launches nothing; and the
kernel's own source, compiled for the CPU with g++ and run a thread per
CUDA thread (``tests/cuda_emulation.h``), agrees with the float64 plain
step on every state group below. What a launch refuses is
``tests/test_torch_cuda_build.py``'s.

On the card (the tests marked ``cuda``; they skip without one) the kernel
is held against the float64 plain step at B = 1, 16 and 32768 + 7 (a tail
block), each state group's error read as ``benchmark/reference``'s
``plant_state_rel`` reads it (the largest difference over the group's
largest change in the step plus its floor) and bounded by 3e-3; pin states
equal; two launches equal bit for bit; the counters advance by one launch
and B scenarios a step, in a rollout too; float64 card tensors are refused.
Where the JAX package is absent:

    python3 -m pytest --noconftest -m cuda tests/test_torch_articulated_kernel.py

The states and the gates are ``chip_smoke.py``'s (``plant_states``,
``plant_gates``), each state seeded: ``rest`` (the standing start, every foot pinned
under holding torques), ``trot`` (one diagonal swinging), ``release`` (a
pinned foot whose knee torque lifts it: its stick normal force comes out
negative), ``knee`` (a pinned leg within 1e-3 rad of straight, beyond the
reach share), ``slip`` (the base sliding over pinned feet under a
friction coefficient of 0.6) and ``touchdown`` (swing feet 1.5 mm over the
ground while the base sinks at 0.5 m/s: they touch in the second
substep).
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
from pathlib import Path

import pytest
import torch

from chip_smoke import (
    PLANT_KINDS, PLANT_OUT, as_float64, plant_gates, plant_near_decisions, plant_outputs,
    plant_plain64, plant_readings, plant_states,
)
from quadruped_locomotion_tpu_torch import sweep
from quadruped_locomotion_tpu_torch.rollout import articulated as art
from quadruped_locomotion_tpu_torch.rollout import closed_loop as cl
from quadruped_locomotion_tpu_torch.utils.logging import counters

ROOT = Path(__file__).resolve().parent.parent
DT = cl.CONTROL_DT


def check_against_plain64(got: dict, model, sim, tau, support, gz, mu,
                          label: str):
    """``chip_smoke.py``'s gates: away from near decisions (at least half
    the scenarios), each state group within 3e-3 of the float64 plain step
    as plant_state_rel reads it, pin states equal, the feet (anchors and
    FK) within 1e-5 m."""
    plant_gates(plant_readings(
        got, sim, plant_plain64(model, sim, tau, support, gz, mu),
        plant_near_decisions(model, sim, tau, support, gz, mu)), label)


def test_the_closed_loop_reads_the_kernel_backed_step():
    assert cl.PLANTS["articulated"] is art.step


@pytest.mark.parametrize("friction_mu", [None, 0.6])
def test_off_the_card_the_step_is_the_plain_step(friction_mu):
    model, sim, tau, support, gz, _ = plant_states("trot", 8, "cpu", seed=5)
    before = (counters["plant.kernel_launches"],
              counters["plant.kernel_instances"])
    got = art.step(model, sim, tau, DT, support=support, ground_height=gz,
                   friction_mu=friction_mu)
    want = art.step_plain(model, sim, tau, DT, support=support,
                          ground_height=gz, friction_mu=friction_mu)
    assert all(torch.equal(a, b) for a, b in zip(plant_outputs(got).values(),
                                                  plant_outputs(want).values()))
    assert torch.equal(got.time, want.time)
    assert (counters["plant.kernel_launches"],
            counters["plant.kernel_instances"]) == before


def test_the_model_is_packed_once():
    """The kernel's model is packed at the first step of a model object
    and reused after; another model object is packed anew."""
    model = plant_states("rest", 1, "cpu")[0]
    packed = art.pack_model(model)
    assert art.pack_model(model) is packed
    assert packed.shape == (art.MODEL_FLOATS,)
    other = model.replace(l2=model.l2 + 0.01)
    assert not torch.equal(art.pack_model(other), packed)


# ---------------------------------------------------------------------------
# the kernel's source on the CPU
# ---------------------------------------------------------------------------

_EMULATED = """
#include "cuda_emulation.h"
#include "articulated_step.cu"
extern "C" void articulated_step_emulated(
    const float* model, const float* pos, const float* quat, const float* vel,
    const float* omega, const float* q, const float* qd,
    const unsigned char* pinned, const float* anchors, const float* tau,
    const unsigned char* support, const float* gz, float* pos_out,
    float* quat_out, float* vel_out, float* omega_out, float* q_out,
    float* qd_out, unsigned char* pinned_out, float* feet_out, int B,
    PlantConsts k, int friction) {
  auto run = [&](auto kernel) {
    emulate_launch((B + WARPS - 1) / WARPS, THREADS, [&, kernel] {
      kernel(model, pos, quat, vel, omega, q, qd, pinned, anchors, tau,
             support, gz, pos_out, quat_out, vel_out, omega_out, q_out,
             qd_out, pinned_out, feet_out, B, k);
    });
  };
  if (friction) run(articulated_step_kernel<true>);
  else run(articulated_step_kernel<false>);
}
"""


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """The kernel's source built for the CPU by g++ (-O1, C++20 for
    std::barrier) against ``tests/cuda_emulation.h``."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel's source for the CPU")
    d = tmp_path_factory.mktemp("articulated_emulated")
    (d / "emulated.cpp").write_text(_EMULATED)
    so = d / "emulated.so"
    proc = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-pthread", "-shared", "-fPIC",
         "-I", str(ROOT / "tests"), "-I", str(art.SOURCE.parent),
         "-o", str(so), str(d / "emulated.cpp")],
        capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    lib = ctypes.CDLL(str(so))
    lib.articulated_step_emulated.argtypes = [ctypes.c_void_p] * 20 + [
        ctypes.c_int, art.PlantConsts, ctypes.c_int]
    lib.articulated_step_emulated.restype = None
    return lib.articulated_step_emulated


def _emulated_step(fn, model, sim, tau, support, gz, mu) -> dict:
    ins = art.kernel_inputs(model, sim, tau, support, gz)
    B = art.KERNEL.check(*ins.values())
    out = {a.name: torch.empty((B, *a.shape), dtype=a.dtype)
           for a in art.KERNEL.outputs}
    fn(*(t.data_ptr() for t in ins.values()),
       *(t.data_ptr() for t in out.values()), B,
       art.plant_consts(DT, art.SUBSTEPS, mu), mu is not None)
    return out


@pytest.mark.parametrize("kind", PLANT_KINDS)
def test_the_kernel_source_on_the_cpu_matches_the_float64_step(emulated,
                                                               kind):
    """Six scenarios (a full block and a tail warp) of each state kind."""
    model, sim, tau, support, gz, mu = plant_states(kind, 6, "cpu", seed=11)
    got = _emulated_step(emulated, model, sim, tau, support, gz, mu)
    check_against_plain64(got, model, sim, tau, support, gz, mu, kind)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 16, 32768 + 7])
@pytest.mark.parametrize("kind", PLANT_KINDS)
def test_the_kernel_matches_the_float64_step(cuda_device, kind, batch):
    model, sim, tau, support, gz, mu = plant_states(kind, batch, cuda_device,
                                                 seed=batch)
    before = (counters["plant.kernel_launches"],
              counters["plant.kernel_instances"])
    got = plant_outputs(art.step(model, sim, tau, DT, support=support,
                         ground_height=gz, friction_mu=mu))
    assert (counters["plant.kernel_launches"],
            counters["plant.kernel_instances"]) == (before[0] + 1,
                                                    before[1] + batch)
    torch.cuda.synchronize()
    check_against_plain64(got, model, sim, tau, support, gz, mu,
                          f"{kind} B={batch}")


@pytest.mark.cuda
def test_on_the_card_float64_is_refused(cuda_device):
    """No fall-back to the plain step on the card: the float64 plain step
    is called by name."""
    model, sim, tau, support, gz, mu = plant_states("rest", 4, cuda_device)
    before = counters["plant.kernel_launches"]
    with pytest.raises(ValueError, match="float32"):
        art.step(model, as_float64(sim), tau.double(), DT, support=support,
                 ground_height=gz.double())
    assert counters["plant.kernel_launches"] == before


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["trot", "slip"])
def test_two_launches_are_equal_bit_for_bit(cuda_device, kind):
    model, sim, tau, support, gz, mu = plant_states(kind, 4096 + 3, cuda_device)
    a, b = (plant_outputs(art.step(model, sim, tau, DT, support=support,
                           ground_height=gz, friction_mu=mu))
            for _ in range(2))
    assert all(torch.equal(a[k], b[k]) for k in PLANT_OUT)


@pytest.mark.cuda
def test_a_rollout_launches_the_kernel_once_a_plant_step(cuda_device):
    """Two planner ticks of 16 config-5 scenarios: 4 plant steps a tick,
    each one launch over the 16 scenarios."""
    sc = sweep.build_scenarios(16, seed=3, device=cuda_device)
    before = (counters["plant.kernel_launches"],
              counters["plant.kernel_instances"])
    cl.rollout(sc.model, sc.params, sc.gait_params, sc.ls0, sc.command, 2,
               qp_iters=30, terrain=sc.terrain, device=cuda_device)
    steps = 2 * cl.CONTROL_SUBSTEPS
    assert (counters["plant.kernel_launches"],
            counters["plant.kernel_instances"]) == (before[0] + steps,
                                                    before[1] + 16 * steps)


@pytest.mark.cuda
def test_the_build_spills_nothing(cuda_device):
    """ptxas's report: no spill stores or loads; the card holds at least
    4 blocks (16 scenarios) an SM."""
    from quadruped_locomotion_tpu_torch.utils.cuda_build import ptxas_report

    build = art.KERNEL.build()
    report = ptxas_report(build.log)
    assert report["spill_store_bytes"] == 0 and report["spill_load_bytes"] == 0
    assert build.resident_blocks_per_sm >= 4
