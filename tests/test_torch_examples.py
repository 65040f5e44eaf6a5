"""The four examples of the port (``examples/torch_*.py``): each runs with
``--device cpu`` in a subprocess at a small size and exits 0, and none of
them leaves ``jax`` or a module of ``repro`` in ``sys.modules``.  The
examples' small models run on one intra-op thread (the tests run beside
other workers)."""

import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: each example with its small-size arguments and its last line
EXAMPLES = {
    "torch_quickstart.py": ([], "quickstart OK"),
    "torch_serve_engine.py": ([], "serve_engine OK"),
    "torch_train_lm.py": (["--steps", "30"],
                          "train_lm OK (failure injected + recovered, "
                          "loss decreased)"),
    "torch_wfe_schemes_tour.py": ([], "amortized reclamation."),
}

# runs an example as __main__ with its arguments, then lists the leaked
# modules
_RUN = """
import runpy, sys
path, argv = sys.argv[1], sys.argv[2:]
sys.argv = [path] + argv
try:
    runpy.run_path(path, run_name="__main__")
except SystemExit as e:
    if e.code:
        raise
leaked = sorted(m for m in sys.modules
                if m in ("jax", "repro") or m.startswith(("jax.", "repro.")))
print("LEAKED", leaked)
"""


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_runs_on_the_cpu_without_jax(name):
    args, last = EXAMPLES[name]
    out = subprocess.run(
        [sys.executable, "-c", _RUN, os.path.join(ROOT, "examples", name),
         "--device", "cpu", *args],
        capture_output=True, text=True, timeout=600, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
             "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert lines[-1] == "LEAKED []", lines[-1]
    assert lines[-2] == last, out.stdout[-2000:]
