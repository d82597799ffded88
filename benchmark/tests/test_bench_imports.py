"""Nothing of the benchmark imports JAX or the JAX package, compared by
whole top-level module names; the references import nothing of the
program either."""

import ast
import os
import subprocess
import sys

from benchmark import run
from benchmark.run import ROOT

JAX = {"jax", "jaxlib", "flax", "rtdm_tpu"}


def _top_level_imports(path):
    tree = ast.parse(open(path).read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def _sources():
    for base, _, files in os.walk(os.path.join(ROOT, "benchmark")):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(base, f)


def test_no_source_imports_jax_or_the_jax_package():
    seen = {}
    for path in _sources():
        names = _top_level_imports(path)
        assert not names & JAX, (path, names & JAX)
        seen[path] = names
    assert any("rtdm_tpu_torch" in n for n in seen.values())


def test_references_import_neither_package():
    ref = os.path.join(ROOT, "benchmark", "reference")
    for f in os.listdir(ref):
        if f.endswith(".py"):
            names = _top_level_imports(os.path.join(ref, f))
            assert names <= {"__future__", "json", "os", "typing", "numpy",
                             "torch"}, (f, names)


def test_the_run_check_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "rtdm_tpu_torch_like", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping_like", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "rtdm_tpu.models", sys)
    assert run.forbidden_modules() == ["rtdm_tpu"]


def test_the_timed_path_loads_no_jax():
    code = ("import benchmark.run as r, benchmark.loops, benchmark.trace;"
            "import rtdm_tpu_torch.export.engine, "
            "rtdm_tpu_torch.export.detector, rtdm_tpu_torch.serve.batcher;"
            "print(r.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_no_card_no_result(capsys, monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "sqernet-bf16.pinned-survey", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out.strip() == ""
