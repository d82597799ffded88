"""The harness finds a new configuration, traffic mix and metric by their
names alone: a later change adds files and entries and edits none."""

import json
import os
import shutil
import subprocess
import sys

import torch

from benchmark.run import ROOT, metrics_of, resolve_cell
from helpers import run_cell


def test_a_dropped_in_cell_runs_without_editing_a_file(tmp_path, capsys):
    root = tmp_path / "checkout"
    root.mkdir()
    shutil.copytree(os.path.join(ROOT, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for name in ("artifacts", "docs", "rtdm_tpu_torch"):
        os.symlink(os.path.join(ROOT, name), root / name)
    before = {p: p.read_bytes() for p in (root / "benchmark").rglob("*")
              if p.is_file()}
    bench = json.loads(open(os.path.join(ROOT, "BENCHMARK.json")).read())

    # new files only: a configuration, a traffic mix and a metric reader
    cfg = json.loads((root / "benchmark/configs/squeeze-ernet-bf16.json")
                     .read_text())
    cfg["name"] = "squeeze-ernet-drop"
    (root / "benchmark/configs/squeeze-ernet-drop.json").write_text(
        json.dumps(cfg))
    (root / "benchmark/traffic/drop.json").write_text(json.dumps(
        {"depth": 1, "pool_batches": 1}))
    (root / "benchmark/metrics/frames_seen.drop.py").write_text(
        "def read(ctx):\n    return float(ctx.win.attempted)\n")
    # and entries
    bench["configs"].append({**bench["configs"][0],
                             "name": "squeeze-ernet-drop",
                             "file": "benchmark/configs/"
                                     "squeeze-ernet-drop.json"})
    bench["workloads"].append({"name": "sqernet-drop.drop",
                               "config": "squeeze-ernet-drop",
                               "traffic": "drop", "chips": 1, "why": "x"})
    for m in bench["end_to_end"]:
        if m["name"] == "images_per_s":
            m["workloads"].append("sqernet-drop.drop")
    bench["per_layer"].append({"name": "frames_seen.drop", "unit": "frames",
                               "better": "higher", "source": "host_clock",
                               "layer": "device", "moves": "images_per_s",
                               "workloads": ["sqernet-drop.drop"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    _, cell, config, traffic = resolve_cell(str(root), "sqernet-drop.drop")
    assert config["name"] == "squeeze-ernet-drop"
    assert traffic["pool_batches"] == 1
    assert [m["name"] for m in metrics_of(bench, cell, True)] == \
        ["frames_seen.drop"]
    torch.set_num_threads(2)
    rc, result = run_cell(capsys, "sqernet-drop.drop", trace=1,
                          root=str(root), batch=4)
    assert rc == 0 and result["correct"]
    assert result["metrics"]["frames_seen.drop"]["value"] >= 4
    rc, result = run_cell(capsys, "sqernet-drop.drop", root=str(root),
                          batch=4)
    assert set(result["metrics"]) == {"images_per_s", "setup_s"}
    for path, data in before.items():
        assert path.read_bytes() == data, path


def test_every_named_file_exists():
    bench = json.loads(open(os.path.join(ROOT, "BENCHMARK.json")).read())
    for c in bench["configs"]:
        cfg = json.loads(open(os.path.join(ROOT, c["file"])).read())
        for kind, key in (("systems", "system"), ("reference", "reference"),
                          ("checks", "check")):
            assert os.path.isfile(os.path.join(
                ROOT, "benchmark", kind, cfg[key] + ".py")), (kind, cfg[key])
    for w in bench["workloads"]:
        assert os.path.isfile(os.path.join(ROOT, "benchmark", "traffic",
                                           w["traffic"] + ".json"))
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert os.path.isfile(os.path.join(ROOT, "benchmark", "metrics",
                                           m["name"] + ".py")), m["name"]


def test_the_benchmark_alone_gives_no_result(tmp_path):
    """In a directory with BENCHMARK.json and the benchmark's files only,
    the run has no program to measure: it fails and prints no result."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys; from benchmark import run; sys.exit(run.main("
            "['--workload', 'sqernet-bf16.pinned-survey', '--seed', '1', "
            "'--seconds', '1', '--trace', '0'], device='cpu'))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300,
                         env=env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
