"""The port's console commands ``trot``, ``pace``, ``edit``, ``update``
and ``--plot`` (``api/cli.py``) against the JAX console's.

JAX outputs: ``tests/data/torch_port_console_golden.npz``
(``scripts/make_torch_port_golden.py --path console``): ``trot`` and
``pace`` for 0.5 s (the printed JSON line and the rollout's per-tick
telemetry), ``edit --script`` over ``EDIT_SCRIPT`` and ``update`` (their
printed output).

The JAX console's gaits run the unbatched rollout through the generic
QP; the port's run the batched rollout at one scenario through its
default backend, the plain version of the kernel on the CPU. So the
gaits are held within 1e-3 m per tick (the bound of ``chip_smoke.py``
phase 4's kernel-vs-plain rollout; the W = 1e-4 flat valley moves forces
by tenths of a newton between solvers). A tick of the articulated plant
with the plain QP takes ~1.8 s on one CPU core, so here each gait runs
GAIT_TICKS of the golden's 50 ticks; ``chip_smoke.py`` phase 15 runs
all 50 on the card. ``edit`` prints JAX's lines, its final feet within
1e-5 m; ``update`` prints JAX's line.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from quadruped_locomotion_tpu_torch.api import cli

ROOT = Path(__file__).resolve().parent.parent
GOLDEN = ROOT / "tests" / "data" / "torch_port_console_golden.npz"
sys.path.insert(0, str(ROOT / "scripts"))
from make_torch_port_golden import EDIT_SCRIPT  # noqa: E402

torch.set_num_threads(1)
GAIT_TICKS = 10
GAIT_TOL = 1e-3  # m


@pytest.fixture(scope="module")
def golden():
    with np.load(GOLDEN) as f:
        return {k: f[k] for k in f.files}


@pytest.mark.parametrize("gait", ["trot", "pace"])
def test_gait_matches_jax_console(golden, gait, tmp_path, monkeypatch,
                                  capsys):
    runs = []
    real = cli.gait_rollout

    def spy(*a, **k):
        runs.append(real(*a, **k))
        return runs[-1]

    monkeypatch.setattr(cli, "gait_rollout", spy)
    png = tmp_path / f"{gait}.png"
    rc = cli.main([gait, "--seconds", str(GAIT_TICKS / 100), "--device",
                   "cpu", "--plot", str(png)])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    want = json.loads(str(golden[f"{gait}/json"]))
    assert rc == 0 == int(golden[f"{gait}/rc"])
    assert list(line) == list(want)
    assert line["gait"] == gait and line["cmd"] == want["cmd"]
    assert line["nan"] is False
    assert png.read_bytes()[:4] == b"\x89PNG"
    tel = runs[0]
    base = tel["base_position"].numpy()
    assert base.shape == (GAIT_TICKS, 3)
    np.testing.assert_allclose(
        base, golden[f"{gait}/tel/base_position"][:GAIT_TICKS], atol=GAIT_TOL,
        rtol=0)
    np.testing.assert_array_equal(tel["support"].numpy(),
                                  golden[f"{gait}/tel/support"][:GAIT_TICKS])
    assert line["final_height"] == pytest.approx(float(base[-1, 2]))


def test_edit_prints_the_jax_console_lines(golden, tmp_path, capsys):
    script = tmp_path / "edit.txt"
    script.write_text("\n".join(EDIT_SCRIPT) + "\n")
    assert cli.main(["edit", "--script", str(script), "--device", "cpu"]) == 0
    got = capsys.readouterr().out.splitlines()
    want = str(golden["edit/stdout"]).splitlines()
    assert got[:-1] == want[:-1]
    g, w = json.loads(got[-1]), json.loads(want[-1])
    np.testing.assert_allclose(g.pop("final_feet"), w.pop("final_feet"),
                               atol=1e-5, rtol=0)
    assert g == w


def test_update_prints_the_jax_console_line(golden, capsys):
    assert cli.main(["update"]) == 0
    assert capsys.readouterr().out == str(golden["update/stdout"])


def test_preview_and_run_plot(tmp_path, capsys):
    pre, run = tmp_path / "preview.png", tmp_path / "run.png"
    cli.main(["preview", "trot_test", "--ticks", "40", "--device", "cpu",
              "--plot", str(pre)])
    cli.main(["run", "standup", "--ticks", "1", "--device", "cpu", "--plot",
              str(run)])
    for p in (pre, run):
        assert p.read_bytes()[:4] == b"\x89PNG"


@pytest.mark.parametrize("argv", [["trot"], ["pace"], ["edit"],
                                  ["run", "standup"], ["preview", "standup"]])
def test_console_runs_on_cuda_by_default(argv):
    if torch.cuda.is_available():
        pytest.skip("the default device is present here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(argv)
