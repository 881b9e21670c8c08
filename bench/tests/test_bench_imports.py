"""No module under bench/ imports JAX or the JAX package, and the reference
imports nothing of the program: top-level module names compared whole
(``repro_torch`` is not ``repro``)."""
import ast
import os
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def imported(path: Path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_no_jax_or_repro_in_bench():
    found = {str(p.relative_to(BENCH)): imported(p) & FORBIDDEN for p in BENCH.rglob("*.py")}
    assert not {k: v for k, v in found.items() if v}


def test_reference_imports_no_program():
    for p in (BENCH / "reference").glob("*.py"):
        assert "repro_torch" not in imported(p), p
    code = ("import sys; import bench.reference.model, bench.reference.train; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'repro_torch', 'repro', 'jax', 'jaxlib', 'flax'}))")
    root = str(BENCH.parent)
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                         env={**os.environ, "PYTHONPATH": root}, check=True)
    assert out.stdout.strip() == "[]", out.stdout + out.stderr
