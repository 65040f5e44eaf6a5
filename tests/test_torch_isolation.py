"""``repro_torch`` stands alone: importing every one of its modules (the
launch tooling of ``repro_torch.launch`` among them) pulls in neither
``jax`` nor any module of ``repro``, and builds no kernel; the port's
examples (``examples/torch_*.py``) import neither, in their source or
when they run (``test_torch_examples.py``)."""

import subprocess
import sys
from pathlib import Path

SRC = Path(__file__).resolve().parents[1] / "src"

PROBE = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules
                if m in ("jax", "repro") or m.startswith(("jax.", "repro.")))
assert not leaked, leaked
from repro_torch.kernels import build
assert build._lib is None, "a kernel library was loaded at import"
print(len(names))
"""


LAUNCH = ("specs", "dryrun", "hlo_analysis", "roofline", "report", "mesh",
          "serve", "train")


def test_port_imports_neither_jax_nor_repro():
    out = subprocess.run([sys.executable, "-c", PROBE], capture_output=True,
                         text=True, timeout=300,
                         env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20  # every module was walked


def test_launch_tooling_is_walked_and_imports_no_reference():
    """Every module of ``repro_torch/launch`` is a module the walk above
    imports, and none names ``jax`` or ``repro`` in an import."""
    launch = Path(SRC, "repro_torch", "launch")
    assert {p.stem for p in launch.glob("*.py")} >= set(LAUNCH)
    for path in launch.glob("*.py"):
        _no_reference_import(path)


def test_examples_import_neither_jax_nor_repro():
    paths = sorted(Path(SRC).parent.glob("examples/torch_*.py"))
    assert [p.name for p in paths] == [
        "torch_quickstart.py", "torch_serve_engine.py", "torch_train_lm.py",
        "torch_wfe_schemes_tour.py"]
    for path in paths:
        _no_reference_import(path)


def _no_reference_import(path: Path) -> None:
    import ast

    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            root = name.split(".")[0]
            assert root not in ("jax", "repro", "benchmarks"), (path, name)
