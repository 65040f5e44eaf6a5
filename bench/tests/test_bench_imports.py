"""Nothing under bench/ imports JAX or the JAX package: every import's
top-level name, the part before the first dot, compared whole
(``repro_torch`` is the port and passes; ``repro`` does not).  And a run
in whose process one was loaded after the window, by the reference, a
metric reader or the trace, prints no result."""

import ast
import json
import sys
import types

import bench_tiny
import pytest

from benchlib import common, serve


def imported_tops(source: str):
    out = set()
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            out.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0:
            out.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            out.add(str(node.args[0].value).split(".")[0])
    return out


FILES = sorted(p for p in common.BENCH.rglob("*.py")
               if "__pycache__" not in p.parts)


@pytest.mark.parametrize("path", FILES,
                         ids=[str(p.relative_to(common.BENCH)) for p in FILES])
def test_no_jax_import(path):
    tops = imported_tops(path.read_text())
    assert not tops & set(common.FORBIDDEN_MODULES), tops


def test_whole_name_comparison():
    assert imported_tops("import repro_torch.serve") == {"repro_torch"}
    assert imported_tops("from repro.models import x") == {"repro"}
    assert common.forbidden_modules(["repro_torch", "repro_torch.serve",
                                     "jaxtyping", "reprox"]) == []
    assert common.forbidden_modules(["jax", "jax.numpy", "repro.core",
                                     "flax", "jaxlib"]) == [
        "flax", "jax", "jax.numpy", "jaxlib", "repro.core"]


RUN = common.load_module(common.BENCH / "run.py", "bench_run_main")


@pytest.fixture(scope="module")
def tiny_run():
    return bench_tiny.serve_run(5)


def _finish(run):
    return RUN.finish("tiny.chat", serve, run, bench_tiny.CFG, 5, False,
                      {"platform": "cpu", "count": 1})


def _unload_forbidden(monkeypatch):
    """Other test files in this process may have loaded the JAX package;
    take it out of ``sys.modules`` for this test only."""
    for name in common.forbidden_modules():
        monkeypatch.delitem(sys.modules, name)


def test_clean_run_prints_its_result(tiny_run, monkeypatch, capsys):
    _unload_forbidden(monkeypatch)
    assert _finish(tiny_run) == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["correct"] is True
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("name", ["jax", "repro.models"])
def test_no_result_once_jax_loads_in_the_checks(tiny_run, monkeypatch,
                                                 capsys, name):
    """A module of JAX or of the JAX package that the checks (the
    reference) load, after the first look at ``sys.modules``, stops the
    result line."""
    _unload_forbidden(monkeypatch)
    real = serve.checks

    def checks(*args, **kw):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
        return real(*args, **kw)
    monkeypatch.setattr(serve, "checks", checks)
    assert _finish(tiny_run) != 0
    captured = capsys.readouterr()
    assert captured.out.strip() == ""
    assert name in captured.err
