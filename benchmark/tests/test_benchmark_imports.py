"""Nothing under benchmark/ imports JAX or the JAX package, compared by
whole top-level module name; the reference imports nothing of the
program either."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
JAX_SIDE = {"jax", "jaxlib", "flax", "quadruped_locomotion_tpu"}
PROGRAM = "quadruped_locomotion_tpu_torch"


def _top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            names.add(node.args[0].value.split(".")[0])
    return names


FILES = sorted(p for p in BENCH.rglob("*.py")  # not what runs left behind
               if not {"out", ".cache"} & set(p.relative_to(BENCH).parts))


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_side_import(path):
    assert not _top_level_imports(path) & JAX_SIDE


@pytest.mark.parametrize(
    "path", sorted((BENCH / "reference").rglob("*.py")),
    ids=lambda p: str(p.relative_to(BENCH)))
def test_reference_imports_nothing_of_the_program(path):
    imported = _top_level_imports(path)
    assert PROGRAM not in imported
    assert imported <= {"torch", "numpy", "math", "dataclasses", "functools",
                        "typing", "__future__", "time"}, imported


def test_the_scan_sees_the_port_prefix_as_its_own_name():
    src = "import quadruped_locomotion_tpu_torch.sweep\nimport jax.numpy\n"
    tmp = BENCH / "out" / "_scan_probe.py"
    tmp.parent.mkdir(exist_ok=True)
    tmp.write_text(src)
    try:
        assert _top_level_imports(tmp) == {PROGRAM, "jax"}
    finally:
        tmp.unlink()
