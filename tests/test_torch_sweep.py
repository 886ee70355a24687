"""The port's config-5 scenario sweep (``sweep.py``, the counterpart of
``bench.py``'s ``build_scenarios`` and ``_sweep_measure``) against the
JAX package.

* ``build_scenarios(16)`` against ``bench.build_scenarios(16)`` (the
  ``sweep/`` section of ``tests/data/torch_port_slice4_refs.npz``): the
  same numpy draws give commands and gait parameters bit for bit and
  states within 1e-6; heights and normals within 1e-6. The maps go
  through a cubic upsampling whose float32 rounding differs between
  XLA's fused contraction and the port's matmuls by a few ulps of values
  up to ~4 (resize within 1e-5), i.e. ~1e-7 m in height; traversability
  is a slope and step filter whose step term has a gain of 1/0.03 m, so
  it is held within 1e-5 and its >= 0.9 mask (what the foothold search
  reads) exactly.
* The closed loop over per-scenario maps and the trot/pace mix, B = 8,
  20 ticks, articulated plant, against the JAX golden
  ``tests/data/torch_port_sweep_golden.npz``
  (``scripts/make_torch_port_golden.py --path sweep``; its flat spawn box
  is shrunk to just cover the stance feet so that the footholds reach
  the bumps). Tolerances as the flat golden's
  (``tests/test_torch_closed_loop.py``): 1e-4 m after one tick, 5e-3 m
  over all ticks, the support sequence exactly.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from quadruped_locomotion_tpu_torch import convert, sweep
from quadruped_locomotion_tpu_torch.control import state_estimator as se
from quadruped_locomotion_tpu_torch.control.locomotion import ControllerParams
from quadruped_locomotion_tpu_torch.gait.phase import GaitParams
from quadruped_locomotion_tpu_torch.ops import fd_qp_kernel
from quadruped_locomotion_tpu_torch.rollout import closed_loop as cl
from quadruped_locomotion_tpu_torch.rollout import estimated_loop as el
from quadruped_locomotion_tpu_torch.terrain.heightfield import Heightfield
from quadruped_locomotion_tpu_torch.types import RobotModel

ROOT = Path(__file__).resolve().parent.parent
REFS = ROOT / "tests" / "data" / "torch_port_slice4_refs.npz"
GOLDEN = ROOT / "tests" / "data" / "torch_port_sweep_golden.npz"
sys.path.insert(0, str(ROOT / "scripts"))
import make_torch_port_references as make_refs  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def scenario_refs():
    with np.load(REFS) as f:
        return {k[len("sweep/"):]: f[k] for k in f.files
                if k.startswith("sweep/")}


@pytest.fixture(scope="module")
def scenarios():
    return sweep.build_scenarios(make_refs.SWEEP_BATCH, 0, "cpu")


def check_scenarios(refs, sc):
    tol = {"height": 1e-6, "normals": 1e-6, "traversability": 1e-5,
           "origin": 0, "resolution": 0}
    hf = convert.to_numpy(sc.terrain)
    for k, t in tol.items():
        np.testing.assert_allclose(hf[k], refs[f"terrain/{k}"], atol=t,
                                   rtol=0, err_msg=k)
    np.testing.assert_array_equal(hf["traversability"] >= 0.9,
                                  refs["terrain/traversability"] >= 0.9)
    for prefix, obj in (("gait_params/", sc.gait_params),
                        ("cmd/", sc.command)):
        got = convert.to_numpy(obj)
        for k, v in got.items():
            np.testing.assert_array_equal(v, refs[prefix + k], err_msg=k)
    ls = convert.to_numpy(sc.ls0)
    for key in (k for k in refs if k.startswith("ls0/")):
        node = ls
        for part in key[len("ls0/"):].split("/"):
            node = node[part]
        np.testing.assert_allclose(node, refs[key], atol=1e-6, rtol=0,
                                   err_msg=key)
    assert str(refs["axes"]) == sweep.SCENARIO_AXES


def test_build_scenarios_matches_bench(scenario_refs, scenarios):
    check_scenarios(scenario_refs, scenarios)


def test_scenario_axes(scenarios):
    """The 3:1 trot/pace interleave, the flat quarter, the pace envelope."""
    B = make_refs.SWEEP_BATCH
    i = np.arange(B)
    t_swing = scenarios.gait_params.t_swing.numpy()
    np.testing.assert_allclose(t_swing, np.where(i % 4 == 3, 0.5, 0.45))
    flat = scenarios.terrain.height.abs().amax((-2, -1)).numpy() == 0
    np.testing.assert_array_equal(flat, i % 4 == 2)
    vx = scenarios.command.linear_velocity[:, 0].numpy()
    assert (vx[i % 4 == 3] >= 0).all() and (vx[i % 4 == 3] <= 0.15).all()
    # the spawn box under the stance feet is flat on every map
    assert scenarios.terrain.height_at(scenarios.ls0.sim.feet_world[..., :2]
                                       ).abs().max() == 0


def test_cubic_resize_matches_jax(scenario_refs):
    """Keys cubic (a = -0.5), half-pixel centres, renormalised border
    weights: jax.image.resize(..., "cubic") on a seeded (16, 8, 8) grid."""
    got = sweep.cubic_resize(torch.from_numpy(scenario_refs["resize/coarse"]),
                             48).numpy()
    np.testing.assert_allclose(got, scenario_refs["resize/fine"], atol=1e-5,
                               rtol=0)
    # not F.interpolate's bicubic (a = -0.75, clamped borders)
    bicubic = torch.nn.functional.interpolate(
        torch.from_numpy(scenario_refs["resize/coarse"])[:, None], size=48,
        mode="bicubic", align_corners=False)[:, 0].numpy()
    assert np.abs(bicubic - scenario_refs["resize/fine"]).max() > 1e-2


@pytest.mark.slow
def test_scenario_references_match_live_jax(scenarios):
    check_scenarios({k: np.asarray(v)
                     for k, v in make_refs.sweep_references().items()},
                    scenarios)


# ---------------------------------------------------------------- golden


def _port_inputs(golden: dict):
    objs = [convert.from_numpy(cls, convert.unflatten(golden, prefix), "cpu")
            for cls, prefix in ((RobotModel, "model/"),
                                (ControllerParams, "params/"),
                                (GaitParams, "gait_params/"),
                                (cl.LocomotionState, "ls0/"),
                                (cl.Command, "cmd/"),
                                (Heightfield, "terrain/"))]
    return objs[:5], objs[5]


def _run_port(golden: dict):
    """(telemetry, the final swing targets)."""
    fd_qp_kernel.launches = 0
    args, terrain = _port_inputs(golden)
    ls, tel = cl.rollout(*args, int(golden["meta/ticks"]), terrain=terrain,
                         plant="articulated", qp_backend="plain", device="cpu")
    assert fd_qp_kernel.launches == 0  # the CPU never reaches the kernel
    return ({k: v.numpy() for k, v in tel.items()},
            ls.gait.swing_targets.numpy())


@pytest.fixture(scope="module")
def golden():
    return dict(np.load(GOLDEN))


@pytest.fixture(scope="module")
def port_run(golden):
    return _run_port(golden)


@pytest.fixture(scope="module")
def port_telemetry(port_run):
    return port_run[0]


def _compare(golden: dict, port: dict):
    ref = {k[len("tel/"):]: v for k, v in golden.items()
           if k.startswith("tel/")}
    assert set(port) == set(ref)
    for k, v in port.items():
        assert v.shape == ref[k].shape, k
        if v.dtype.kind == "f":
            assert np.isfinite(v).all(), k
    np.testing.assert_allclose(port["base_position"][0],
                               ref["base_position"][0], atol=1e-4, rtol=0)
    np.testing.assert_allclose(port["feet_world"][0], ref["feet_world"][0],
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(port["base_position"], ref["base_position"],
                               atol=5e-3, rtol=0)
    np.testing.assert_array_equal(port["support"], ref["support"])


def test_sweep_rollout_matches_jax_golden(golden, port_run):
    _compare(golden, port_run[0])
    # the footholds reached the bumps beyond the shrunk spawn box
    assert golden["meta/flat_zone"][0] < sweep.FLAT_ZONE[0]
    assert np.abs(port_run[1][..., 2]).max() > 1e-3


@pytest.mark.parametrize("field", ["leg_state", "base_quaternion",
                                   "base_velocity", "feet_world", "qp_kkt"])
def test_sweep_fields_track_golden(golden, port_telemetry, field):
    """The FSM's leg states exactly; orientation within 1e-3, velocity
    within 5e-2 m/s, feet within 5e-3 m (the flat-valley drift of the base
    position); both sides' QP KKT below 1e-2 on every tick."""
    got, want = port_telemetry[field], golden[f"tel/{field}"]
    if field == "leg_state":
        np.testing.assert_array_equal(got, want)
    elif field == "qp_kkt":
        assert got.max() < 1e-2 and want.max() < 1e-2
    else:
        tol = {"base_quaternion": 1e-3, "base_velocity": 5e-2,
               "feet_world": 5e-3}[field]
        np.testing.assert_allclose(got, want, atol=tol, rtol=0)


@pytest.mark.slow
def test_sweep_matches_live_jax():
    from make_torch_port_golden import make_sweep_golden

    golden = make_sweep_golden(batch=8, ticks=20, seed=0)
    _compare(golden, _run_port(golden)[0])


def test_measure_reports_bench_fields():
    res = sweep.measure(8, ticks=1, device="cpu")
    assert res["batch"] == 8 and res["ticks"] == 1
    assert res["finite"] and res["upright_frac"] == 1.0
    assert res["rt_factor"] > 0 and res["wall_s"] > 0
    assert res["p99_kkt"] < 1e-2
    assert res["scenario_axes"] == sweep.SCENARIO_AXES


def test_entry_points_default_to_cuda(monkeypatch):
    """device=None means CUDA; without it the new entry points raise
    instead of falling back to the CPU."""
    gp = GaitParams.trot_defaults("cpu")
    model = RobotModel.simpledog("cpu")
    els = el.init_estimated(model, gp, 2, device="cpu")
    cmd = cl.Command(linear_velocity=torch.zeros(2, 3), yaw_rate=torch.zeros(2))
    est_args = (model, ControllerParams.defaults("cpu"), gp,
                se.EstimatorParams.defaults("cpu"),
                el.SensorParams.ideal("cpu"), els, cmd, 1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [
        lambda: el.rollout_estimated(*est_args),
        lambda: sweep.measure(8, ticks=1),
        lambda: sweep.build_scenarios(8),
        lambda: cl.init_locomotion_mixed(model, gp.per_scenario(2),
                                         torch.zeros(2, dtype=torch.long)),
        lambda: el.init_estimated(model, gp, 2),
        lambda: Heightfield.flat(2),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
