"""A cell on the card, short: run with ``-m cuda`` on a machine with an
NVIDIA GPU. Skips without one."""

import json
import os
import subprocess
import sys

import pytest

from benchmark.run import ROOT


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["sqernet-bf16.pinned-survey",
                                      "yolov4tiny-int8.survey"])
def test_cell_runs_correct_on_the_card(workload):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", workload,
         "--seed", "2147483901", "--seconds", "2", "--trace", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=1200,
        env={**os.environ})
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], out.stderr[-4000:]
    assert result["device"]["platform"] == "gpu"
    assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
