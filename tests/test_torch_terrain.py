"""The port's heightfield terrain (``terrain/heightfield.py``) and the gait
engine over per-scenario maps with per-scenario gait parameters, against
the JAX package.

Inputs come from numpy seeds in ``scripts/make_torch_port_references.py``;
the JAX outputs are the ``terrain/``, ``gait_b6/`` and ``gait_b4/``
sections of ``tests/data/torch_port_slice4_refs.npz`` (``-m slow``
recomputes them live and repeats the checks).

Tolerances: the maps and the point queries run the same float32
operations on identical heights, so fields and heights agree within 1e-6
(observed: bit for bit); the foothold search picks the same cells (the
chosen xy is the same float32 expression of the cell index, compared
exactly), including a constructed four-way tie, which both sides break
toward the first cell in window order. The gait engine over ten ticks:
support and phase masks exactly, footholds and positions within 1e-5 m,
velocities within 1e-4 and accelerations within 1e-2 (the spline's 1/h
and 1/h² amplify ulps, as in ``tests/test_torch_gait_sim.py``).
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from quadruped_locomotion_tpu_torch import convert
from quadruped_locomotion_tpu_torch.gait import gait_generator as tgg
from quadruped_locomotion_tpu_torch.gait import phase as tphase
from quadruped_locomotion_tpu_torch.gait.phase import GaitParams
from quadruped_locomotion_tpu_torch.rollout import simulator as tsim
from quadruped_locomotion_tpu_torch.terrain import heightfield as th
from quadruped_locomotion_tpu_torch.types import RobotModel, where_tree

ROOT = Path(__file__).resolve().parent.parent
REFS = ROOT / "tests" / "data" / "torch_port_slice4_refs.npz"
sys.path.insert(0, str(ROOT / "scripts"))
import make_torch_port_references as make_refs  # noqa: E402

torch.set_num_threads(1)

FIELD_TOL = 1e-6
POS = dict(atol=1e-5, rtol=1e-5)
VEL = dict(atol=1e-4, rtol=1e-4)
ACC = dict(atol=1e-2, rtol=1e-4)
DT = 0.01


def _section(name):
    with np.load(REFS) as f:
        return {k[len(name) + 1:]: f[k] for k in f.files
                if k.startswith(name + "/")}


@pytest.fixture(scope="module")
def terrain_refs():
    return _section("terrain")


def _port_maps(refs):
    return th.Heightfield.from_height_array(
        torch.from_numpy(refs["in/height"]), origin=torch.from_numpy(
            refs["in/origin"]), resolution=torch.from_numpy(
            refs["in/resolution"]))


# ---------------------------------------------------------------- maps


@pytest.mark.parametrize("field", ["height", "traversability", "normals",
                                   "origin", "resolution"])
def test_heightfield_fields_match_jax(terrain_refs, field):
    got = getattr(_port_maps(terrain_refs), field).numpy()
    want = terrain_refs[f"hf/{field}"]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=FIELD_TOL, rtol=0)


@pytest.mark.parametrize("query", ["height_at", "normal_at",
                                   "traversability_at", "cell_index"])
def test_point_queries_match_jax(terrain_refs, query):
    """Seeded points over and beyond each map (its corners and the points
    0.3 m outside them included, which clamp)."""
    hf = _port_maps(terrain_refs)
    pts = torch.from_numpy(terrain_refs["in/points"])
    if query == "cell_index":
        ix, iy = hf.cell_index(pts)
        np.testing.assert_array_equal(ix.numpy(), terrain_refs["cell_ix"])
        np.testing.assert_array_equal(iy.numpy(), terrain_refs["cell_iy"])
        assert ix.min() == 0 and ix.max() == make_refs.TERRAIN_CELLS - 1
        return
    got = getattr(hf, query)(pts).numpy()
    np.testing.assert_allclose(got, terrain_refs[query], atol=FIELD_TOL, rtol=0)


def check_footholds(refs, tag):
    hf = _port_maps(refs)
    hips = torch.from_numpy(refs["in/hips"]) if tag == "hips" else None
    f, n, found = th.optimize_footholds(
        hf, torch.from_numpy(refs["in/nominal"]), hips)
    np.testing.assert_array_equal(found.numpy(), refs[f"{tag}/found"])
    # the same cells: identical float32 expressions of the cell index
    np.testing.assert_array_equal(f[..., :2].numpy(),
                                  refs[f"{tag}/footholds"][..., :2])
    np.testing.assert_allclose(f[..., 2].numpy(),
                               refs[f"{tag}/footholds"][..., 2],
                               atol=FIELD_TOL, rtol=0)
    np.testing.assert_allclose(n.numpy(), refs[f"{tag}/normals"],
                               atol=FIELD_TOL, rtol=0)
    return f


@pytest.mark.parametrize("tag", ["no_hips", "hips"])
def test_optimize_footholds_match_jax(terrain_refs, tag):
    f = check_footholds(terrain_refs, tag)
    pit = f[1, 0].numpy()
    if tag == "hips":
        # the pit's floor is flat but out of the leg's reach: the foothold
        # moves out of the pit, onto the flat around it
        assert np.hypot(pit[0] - 0.3, pit[1]) > 0.05 and abs(pit[2]) < 0.02
    else:  # without the reach check, the flat pit floor is steppable
        assert abs(pit[2] + 0.2) < 1e-6


def test_foothold_tie_takes_the_first_cell(terrain_refs):
    """On the spike map the nominal foothold sits on the spike's cell;
    its four diagonal neighbours are traversable and exactly equidistant
    (1/16 m cells), and the first in row-major window order, (-1, -1),
    wins on both sides."""
    hf = _port_maps(terrain_refs)
    assert hf.traversability[2, 50, 50] < 0.9
    diag = hf.traversability[2, [49, 49, 51, 51], [49, 51, 49, 51]]
    assert (diag >= 0.9).all()
    f, _, found = th.optimize_footholds(
        hf, torch.from_numpy(terrain_refs["in/nominal"]))
    assert found[2, 0]
    np.testing.assert_array_equal(f[2, 0, :2].numpy(), [-0.0625, -0.0625])
    np.testing.assert_array_equal(terrain_refs["no_hips/footholds"][2, 0, :2],
                                  [-0.0625, -0.0625])


def test_flat_map_snaps_to_the_nominal_cell():
    hf = th.Heightfield.flat(3, device="cpu")
    nominal = torch.tensor([[[0.3, -0.2, 0.0]], [[0.31, 0.0, 0.0]],
                            [[-3.99, 3.99, 0.0]]])
    f, n, found = th.optimize_footholds(hf, nominal)
    assert found.all()
    np.testing.assert_allclose(f[..., :2].numpy(), [[[0.32, -0.2]],
                                                    [[0.32, 0.0]],
                                                    [[-4.0, 3.96]]], atol=1e-6)
    np.testing.assert_array_equal(n.numpy(), np.broadcast_to([0, 0, 1],
                                                             (3, 1, 3)))


@pytest.mark.slow
def test_terrain_references_match_live_jax():
    live = {k: np.asarray(v) for k, v in make_refs.terrain_references().items()}
    for tag in ("no_hips", "hips"):
        check_footholds(live, tag)
    hf = _port_maps(live)
    for field in ("height", "traversability", "normals"):
        np.testing.assert_allclose(getattr(hf, field).numpy(),
                                   live[f"hf/{field}"], atol=FIELD_TOL, rtol=0)


# ---------------------------------------------------------------- gait


def _gait_inputs(refs):
    model = RobotModel.simpledog("cpu")
    gp = convert.from_numpy(GaitParams, convert.unflatten(
        refs, "in/gait_params/"), "cpu")
    sim = convert.from_numpy(tsim.SimState, convert.unflatten(refs, "in/sim/"),
                             "cpu")
    hf = th.Heightfield.from_height_array(
        torch.from_numpy(refs["in/height"]), origin=(-2.4, -2.4),
        resolution=0.1)
    pace = torch.from_numpy(refs["in/is_pace"])
    gait = where_tree(
        pace, tgg.init_gait_state(tphase.PACE, gp, sim.feet_world),
        tgg.init_gait_state(tphase.TROT, gp, sim.feet_world))
    return model, gp, sim, hf, gait


def check_gait(refs):
    model, gp, sim, hf, gait = _gait_inputs(refs)
    want0 = convert.unflatten(refs, "gait0/")
    got0 = convert.to_numpy(gait)
    np.testing.assert_allclose(got0["phase"]["stance_phase"],
                               want0["phase"]["stance_phase"], atol=1e-6)
    lin, wz = torch.from_numpy(refs["in/lin"]), torch.from_numpy(refs["in/wz"])
    tick = convert.unflatten(refs, "tick/")
    moved = 0
    for t in range(make_refs.GAIT_TICKS):
        gait, sup, (pos, vel, acc), tgt, nrm = tgg.advance(
            model, gait, sim.robot, sim.feet_world, gp, lin, wz, DT,
            terrain=hf)
        np.testing.assert_array_equal(sup.numpy(), tick["support"][t])
        np.testing.assert_allclose(gait.swing_targets.numpy(),
                                   tick["swing_targets"][t], **POS)
        np.testing.assert_allclose(pos.numpy(), tick["pos"][t], **POS)
        np.testing.assert_allclose(vel.numpy(), tick["vel"][t], **VEL)
        np.testing.assert_allclose(acc.numpy(), tick["acc"][t], **ACC)
        np.testing.assert_allclose(nrm.numpy(), tick["normals"][t], **POS)
        np.testing.assert_allclose(gait.base_ref_pos.numpy(),
                                   tick["base_ref_pos"][t], **POS)
        for f, v in convert.to_numpy(tgt).items():
            np.testing.assert_allclose(v, tick["target"][f][t], **VEL)
        moved += int((np.abs(tick["normals"][t][..., 2] - 1.0) > 1e-6).sum())
    # the maps reach the footholds: some legs' target cells are tilted
    assert moved > 0


@pytest.mark.parametrize("batch", make_refs.GAIT_BATCHES)
def test_gait_advance_terrain_mixed_params_matches_jax(batch):
    """Ten ticks of the gait engine over per-scenario maps with
    per-scenario trot/pace parameters, each leaf scaled so that no two
    scenarios share a value (B = 4 catches a (B,) leaf broadcast along
    the leg axis)."""
    refs = _section(f"gait_b{batch}")
    assert len(np.unique(refs["in/gait_params/t_swing"])) == batch
    check_gait(refs)


@pytest.mark.slow
@pytest.mark.parametrize("batch", make_refs.GAIT_BATCHES)
def test_gait_references_match_live_jax(batch):
    check_gait({k: np.asarray(v)
                for k, v in make_refs.gait_references(batch).items()})
