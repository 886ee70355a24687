"""The PyTorch port, its GPU smoke script and its realtime measurement
script import neither JAX nor the JAX package: every ``.py`` file of
``quadruped_locomotion_tpu_torch/`` (its copy of the bundled python
action included), ``chip_smoke.py`` and ``scripts/measure_realtime_torch.py``
is parsed and its imports checked; and the port's action loader runs the
bundled python action in a fresh process without JAX being imported."""

from __future__ import annotations

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FILES = sorted((ROOT / "quadruped_locomotion_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "scripts" / "measure_realtime_torch.py"]
BANNED = ("jax", "jaxlib", "flax", "quadruped_locomotion_tpu")


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _banned(module: str) -> bool:
    return module.split(".")[0] in BANNED


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = [m for m in _imports(path) if _banned(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scan_sees_the_package():
    assert len(FILES) > 20
    # the check itself: the port's own name is not mistaken for the JAX one
    assert not _banned("quadruped_locomotion_tpu_torch.ops")
    assert _banned("quadruped_locomotion_tpu.ops.qp") and _banned("jax.numpy")


LOADER_CHECK = """
import sys
from quadruped_locomotion_tpu_torch.api.action_loader import ActionLoader
loader = ActionLoader(device="cpu")
act = loader.send_action("velocity_trot")
assert type(act).__name__ == "VelocityTrotAction", act
assert act.state == 2 and loader.server._active == 1  # PENDING, one row
bad = sorted(m for m in sys.modules if m.split(".")[0] in {banned})
assert not bad, bad
print("no jax")
"""


def test_loader_runs_the_bundled_python_action_without_jax():
    """In a subprocess (this test session imports JAX): the registry's
    python action resolves to the port's copy, which the loader runs."""
    code = LOADER_CHECK.format(banned=set(BANNED))
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == "no jax"
