"""``repro_torch`` and ``chip_smoke.py`` stand alone: they import neither
jax nor ``repro``, and nothing in them falls back to the CPU when CUDA is
asked for and absent."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "repro"}
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


def test_no_file_imports_jax_or_repro():
    assert (ROOT / "chip_smoke.py").exists()
    bad = {str(p.relative_to(ROOT)): sorted(set(_imported_roots(p)) & FORBIDDEN)
           for p in FILES}
    assert not {k: v for k, v in bad.items() if v}


def test_every_module_imports_with_jax_and_repro_blocked():
    code = (
        "import importlib, pkgutil, sys\n"
        "sys.modules['jax'] = sys.modules['repro'] = None\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "assert 'repro_torch.models.zoo' in names and 'repro_torch.kernels.ops' in names\n"
        "print(len(names))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 20


def _require_no_gpu():
    if torch.cuda.is_available():
        pytest.skip("holds only on a machine without a CUDA device")


def test_model_without_device_raises_on_a_machine_without_gpu():
    _require_no_gpu()
    from repro_torch.configs import registry
    from repro_torch.models import zoo

    with pytest.raises(RuntimeError, match="cuda"):
        zoo.Model(registry.get("qwen3-1.7b", reduced=True))


def test_serve_fns_without_device_raise_on_a_machine_without_gpu():
    _require_no_gpu()
    from repro_torch.configs import registry
    from repro_torch.models import zoo
    from repro_torch.runtime.serve import build_serve_fns

    model = zoo.Model(registry.get("qwen3-1.7b", reduced=True), device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        build_serve_fns(model, max_len=8)
    prefill_fn, _ = build_serve_fns(model, max_len=8, device="cpu")
    assert callable(prefill_fn)


def test_serve_launcher_refuses_missing_cuda():
    _require_no_gpu()
    from repro_torch.launch import serve

    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--arch", "qwen3-1.7b", "--reduced"])


def test_chip_smoke_refuses_a_machine_without_gpu():
    _require_no_gpu()
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
