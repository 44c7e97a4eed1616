"""The port stands alone: no file of ``repro_torch``, and not
``chip_smoke.py``, imports JAX, the JAX package or ``ml_dtypes`` (the
machine with the card has none; bf16 arrays go through their bits)."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro", "ml_dtypes")


def _imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _modules():
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(PORT.parent).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_imports(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_every_module_imports_with_jax_blocked():
    modules = list(_modules())
    assert len(modules) >= 20
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "sys.modules['ml_dtypes'] = None\n"
        "import importlib\n"
        f"for name in {modules!r}:\n"
        "    importlib.import_module(name)\n"
        "from repro_torch.kernels import _build\n"
        "assert _build._libs == {}, 'importing built a kernel'\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")}, timeout=120,
    )
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_the_training_modules_are_checked():
    """The LM zoo's training path (Slices F6-F7) is among the modules both
    tests above hold to the rule."""
    modules = set(_modules())
    assert {"repro_torch.optim.schedules", "repro_torch.optim.accumulation",
            "repro_torch.optim.compression", "repro_torch.runtime.train_loop",
            "repro_torch.launch.train", "repro_torch.models.lm"} <= modules
    assert {PORT / "launch" / "train.py", PORT / "runtime" / "train_loop.py"} <= set(FILES)
