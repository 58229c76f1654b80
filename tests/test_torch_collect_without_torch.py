"""Without torch, the port's test files skip and the JAX package's tests
still collect. A checkout installed from ``requirements.txt`` alone has no
torch; an import error in one port file would stop pytest's whole
collection ("Interrupted: 1 error during collection").

* every ``tests/test_torch_*.py`` calls ``pytest.importorskip("torch")``
  at module level before any import of torch, ``repro_torch``,
  ``chip_smoke``, ``benchmarks.torch_*``, ``tools.*_torch`` or a
  ``_torch_*``/``test_torch_*`` test module (this file imports none, so
  it runs without torch too);
* with torch blocked (``sys.modules["torch"] = None``), collecting a port
  file and a JAX test file exits 0: the port file skips, the JAX tests
  collect.
"""
import ast
import glob
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.basename(__file__)
PORT_TESTS = sorted(os.path.basename(p) for p in glob.glob(
    os.path.join(ROOT, "tests", "test_torch_*.py")))


def _needs_torch(module: str) -> bool:
    parts = module.split(".")
    return (parts[0] in ("torch", "repro_torch", "chip_smoke")
            or parts[0].startswith(("_torch_", "test_torch_"))
            or (parts[0] == "benchmarks" and len(parts) > 1
                and parts[1].startswith("torch_"))
            or (parts[0] == "tools" and len(parts) > 1
                and parts[1].endswith("_torch")))


def _torch_imports(tree) -> list:
    """(line, module) of every import, at any depth, that needs torch."""
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out += [(node.lineno, a.name) for a in node.names
                    if _needs_torch(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module:
            out += [(node.lineno, f"{node.module}.{a.name}")
                    for a in node.names
                    if _needs_torch(node.module)
                    or _needs_torch(f"{node.module}.{a.name}")]
    return out


def _skip_line(tree):
    """The line of the module-level ``pytest.importorskip("torch")``."""
    for node in tree.body:
        call = getattr(node, "value", None)
        if (isinstance(node, (ast.Expr, ast.Assign))
                and isinstance(call, ast.Call)
                and isinstance(call.func, ast.Attribute)
                and call.func.attr == "importorskip"
                and getattr(call.func.value, "id", None) == "pytest"
                and [getattr(a, "value", None) for a in call.args]
                == ["torch"]):
            return node.lineno
    return None


@pytest.mark.parametrize("name", PORT_TESTS)
def test_port_file_skips_before_importing_torch(name):
    with open(os.path.join(ROOT, "tests", name)) as f:
        tree = ast.parse(f.read(), filename=name)
    imports, skip = _torch_imports(tree), _skip_line(tree)
    if name == HERE:
        assert imports == [], f"{name} must import nothing of torch"
        return
    assert skip is not None, f"{name} has no pytest.importorskip('torch')"
    early = [(line, mod) for line, mod in imports if line < skip]
    assert not early, f"{name} imports {early} before its importorskip"


BLOCKED = ("import sys; sys.modules['torch'] = None; import pytest; "
           "sys.exit(pytest.main(['--collect-only', '-q', '-rs', '-p', "
           "'no:cacheprovider', 'tests/test_torch_cuda.py', "
           "'tests/test_theory.py']))")


def test_collection_without_torch_skips_the_port():
    out = subprocess.run(
        [sys.executable, "-c", BLOCKED], cwd=ROOT, capture_output=True,
        text=True, timeout=300,
        env={**os.environ, "JAX_PLATFORMS": "cpu",
             "PYTHONPATH": os.path.join(ROOT, "src")})
    text = out.stdout + out.stderr
    assert out.returncode == 0, text
    assert "SKIPPED [1] tests/test_torch_cuda.py" in text, text
    assert "could not import 'torch'" in text, text
    assert "ERROR" not in text and "Interrupted" not in text, text
    assert "tests/test_theory.py::" in text, text
    assert "tests/test_torch_cuda.py::" not in text, text
