"""``repro_torch`` stands alone: importing every one of its modules pulls in
neither ``jax`` nor any module of ``repro``, and builds no kernel."""

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


def test_port_imports_neither_jax_nor_repro():
    out = subprocess.run([sys.executable, "-c", PROBE], capture_output=True,
                         text=True, timeout=300,
                         env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20  # every module was walked
