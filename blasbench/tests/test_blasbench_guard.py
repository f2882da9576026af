"""Nothing the benchmark runs loads JAX or the JAX package, compared by whole
top-level names, and the reference loads nothing of the port."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from blasbench import HERE, ROOT, guard


@pytest.mark.parametrize("modules, found", [
    (["jax", "jax.numpy"], ["jax"]),
    (["jaxlib.xla_client"], ["jaxlib"]),
    (["flax.linen"], ["flax"]),
    (["accblas_tpu", "accblas_tpu.ops.dot"], ["accblas_tpu"]),
    (["accblas_tpu_torch", "accblas_tpu_torch.ops.dot"], []),
    (["jaxtyping", "accblas_tpu_tools", "torch", "numpy"], []),
])
def test_whole_top_level_names(modules, found):
    assert guard.forbidden(modules) == found


def _imports(path: Path) -> set:
    """Top-level names of the modules a source file imports (absolute ones)."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
    return out


def test_no_source_imports_jax_or_the_jax_package():
    for path in HERE.rglob("*.py"):
        assert not _imports(path) & guard.FORBIDDEN, path


def test_reference_imports_nothing_of_the_port():
    for path in (HERE / "reference").glob("*.py"):
        assert guard.PORT not in _imports(path), path
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.ImportFrom) and node.level:
                assert node.level == 1, f"{path}: reaches out of reference/"


def _fresh(code: str) -> str:
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=300, check=True).stdout


def test_reference_loads_nothing_of_the_port_in_a_fresh_process():
    out = _fresh("import sys; import blasbench.reference.blas, blasbench.reference.cg; "
                 "print(sorted({m.split('.')[0] for m in sys.modules} & "
                 "{'accblas_tpu_torch', 'accblas_tpu', 'jax', 'jaxlib', 'flax'}))")
    assert out.strip() == "[]"


def test_a_run_loads_no_forbidden_module():
    """A whole CPU run of each cell's driver, then the guard on sys.modules."""
    out = _fresh(
        "import torch; from blasbench import spec, run, guard\n"
        "for op, n in [('cg', 64), ('trsv', 128), ('dot', 4096)]:\n"
        "    c = spec.cell(spec.first_cell_of(op)); c.mix['n'] = n\n"
        "    r = run.run_cell(c, 5, 0.2, True, torch.device('cpu'))\n"
        "    assert r['correct'], r\n"
        "print(guard.forbidden())")
    assert out.strip().splitlines()[-1] == "[]"


def test_port_must_come_from_the_checkout(tmp_path):
    fake = type("M", (), {"__file__": str(tmp_path / guard.PORT / "__init__.py")})
    assert guard.port_outside(ROOT, fake) is not None
    import accblas_tpu_torch

    assert guard.port_outside(ROOT, accblas_tpu_torch) is None
