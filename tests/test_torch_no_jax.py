"""The PyTorch port, its GPU smoke script and its realtime measurement
script import neither JAX nor the JAX package: every ``.py`` file of
``quadruped_locomotion_tpu_torch/``, ``chip_smoke.py`` and
``scripts/measure_realtime_torch.py`` is parsed and its imports checked."""

from __future__ import annotations

import ast
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
