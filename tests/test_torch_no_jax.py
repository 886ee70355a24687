"""The PyTorch port, its GPU smoke script and its realtime measurement
script import neither JAX nor the JAX package, and read or run nothing
under the JAX package's tree: every ``.py`` file of
``quadruped_locomotion_tpu_torch/`` (its copies of the bundled python and
launch actions included), ``chip_smoke.py`` and
``scripts/measure_realtime_torch.py`` is parsed, its imports checked, and
its string constants searched for the JAX package's name as a path or
module component; the port's copies of the bundled data (the URDF, the
motion scripts, the action library) equal the JAX package's files byte
for byte; and the port's action loader runs the bundled python action in
a fresh process without JAX being imported."""

from __future__ import annotations

import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
JAX_PKG = ROOT / "quadruped_locomotion_tpu"
PORT_PKG = ROOT / "quadruped_locomotion_tpu_torch"
FILES = sorted(PORT_PKG.rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "scripts" / "measure_realtime_torch.py"]
BANNED = ("jax", "jaxlib", "flax", "quadruped_locomotion_tpu")
# the JAX package's bundled data, of which the port keeps copies at the
# same relative paths
BUNDLED_DATA = sorted(
    [JAX_PKG / "assets" / "simpledog.urdf",
     JAX_PKG / "api" / "action_library" / "launch" / "external_demo.py"]
    + list((JAX_PKG / "api" / "motion_scripts").glob("*.yaml"))
    + [f for d in ("actions", "collections", "combined")
       for f in (JAX_PKG / "api" / "action_library" / d).glob("*.yaml")])


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


@pytest.mark.parametrize("path", BUNDLED_DATA,
                         ids=lambda p: str(p.relative_to(JAX_PKG)))
def test_bundled_data_copies_equal_the_jax_packages(path):
    copy = PORT_PKG / path.relative_to(JAX_PKG)
    assert copy.read_bytes() == path.read_bytes(), copy


def test_bundled_data_is_complete():
    assert len(BUNDLED_DATA) == 18  # URDF, launch action, 13 scripts, 3 YAML


def _named_constants(path: Path):
    """(line, value) of each string constant of ``path`` that names the
    JAX package as a path or module component. Docstrings may name the
    counterpart module; the values of ``"replaces"`` keys name the TPU
    kernel that a port replaces (the smoke run's kernels record)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    skip = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)):
            body = node.body
            if (body and isinstance(body[0], ast.Expr)
                    and isinstance(body[0].value, ast.Constant)):
                skip.add(id(body[0].value))
        if isinstance(node, ast.Dict):
            skip.update(id(v) for k, v in zip(node.keys, node.values)
                        if isinstance(k, ast.Constant) and k.value == "replaces")
    for node in ast.walk(tree):
        if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                and id(node) not in skip
                and "quadruped_locomotion_tpu" in re.findall(r"\w+", node.value)):
            yield node.lineno, node.value


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_path_into_the_jax_package(path):
    bad = list(_named_constants(path))
    assert not bad, f"{path.relative_to(ROOT)} names the JAX package: {bad}"


def test_path_scan_finds_a_path_into_the_jax_package(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text('"""quadruped_locomotion_tpu/types.py"""\n'
                     'A = {"replaces": "quadruped_locomotion_tpu/ops/x.py:1"}\n'
                     'B = Path(ROOT) / "quadruped_locomotion_tpu" / "assets"\n'
                     'C = "-m quadruped_locomotion_tpu.bench"\n'
                     'D = "quadruped_locomotion_tpu_torch/assets"\n')
    assert sorted(ln for ln, _ in _named_constants(probe)) == [3, 4]


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
