"""The port's data-parallel detector train step against JAX's 8-device
mesh.

A gloo group of 2 CPU processes (``tests/torch_parallel_jobs.py``
``job_yolo``) runs ``cli/yolo_train.py::make_train_step`` with a mesh, and
this process jits JAX's step over its virtual 8-device mesh as
``rtdm_tpu/cli/yolo_train.py`` does (``tests/torch_port_goldens.py::
jax_yolo_case``), both on the detector train golden's first 8 frames at
416 from the committed detectors' dequantized weights, the first step (the
compile of JAX's sharded step is most of this file's time): case a
(yolov5s-mini, v5 loss, SGD, EMA) and case b (yolov4-tiny-mini, v3 loss,
two microbatches, BN burn-in), each within ``chip_smoke.YOLO_GATES`` of
its case. JAX's 8-way step is its one-device step on the global batch
(``tests/test_parallel.py``), the golden's reference.
"""

import json

import numpy as np
import pytest
import torch

import jax

import chip_smoke
from tests import torch_parallel_jobs as J

CASES = ("a", "b")


@pytest.fixture(autouse=True)
def two_threads(monkeypatch):
    monkeypatch.setenv("RTDM_XLA_CACHE", "0")
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _jax_ref(case, golden, work):
    """JAX's step jitted over the 8-device mesh, in
    ``chip_smoke.golden_yolo_ref``'s layout (the golden's leaves)."""
    from rtdm_tpu.core.mesh import create_mesh

    from tests.torch_port_goldens import jax_yolo_case
    batch = {"image": golden["images"], "labels": golden["labels"],
             "num_labels": golden["num_labels"]}
    res = jax_yolo_case(case, batch, str(work / f"jax_{case}"),
                        steps=1,
                        mesh=create_mesh((8,), ("data",),
                                         jax.devices()[:8]))
    leaves = json.loads(str(golden[f"{case}/leaves"]))
    return {"loss": np.array(res["loss"]), "comps": np.stack(res["comps"]),
            "grad_norm": np.array(res["grad_norm"]),
            "vars": {k: np.stack([v[k] for v in res["vars"]])
                     for k in leaves["params"] + leaves["stats"]},
            "ema": {k: np.stack([v[k] for v in res["ema"]])
                    for k in leaves["ema"]}}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("parallel_yolo_jax")
    group = J.start_group("yolo", 2, work / "w2")
    golden = J.yolo_golden_batch()
    ref = {c: _jax_ref(c, golden, work) for c in CASES}
    return group.results(), ref


@pytest.mark.parametrize("case", CASES)
def test_step_meets_jax_eight_way(runs, case):
    ranks, ref = runs
    for res in ranks:
        run = chip_smoke.unflat_yolo_run(res, f"{case}/")
        first = {k: (v[:1] if k in ("loss", "comps", "grad_norm")
                     else {n: a[:1] for n, a in v.items()})
                 for k, v in run.items()}
        gap = chip_smoke.yolo_gaps(ref[case], first)
        print(f"case {case} against JAX's 8-way step: "
              + chip_smoke._fmt(gap))
        assert all(g <= t for g, t in zip(gap, chip_smoke.YOLO_GATES[case])
                   ), (case, gap, chip_smoke.YOLO_GATES[case])
