"""The port stands alone: no file of ``rtdm_tpu_torch/`` and not
``chip_smoke.py`` imports JAX, its libraries or ``rtdm_tpu``, and importing
the package loads none of them."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "rtdm_tpu")
FILES = sorted((ROOT / "rtdm_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path} imports {bad}"


def test_importing_the_port_loads_no_jax():
    code = ("import sys, rtdm_tpu_torch.export.engine, "
            "rtdm_tpu_torch.cli.aider_predict, rtdm_tpu_torch.models, "
            "rtdm_tpu_torch.cli.build_engine, "
            "rtdm_tpu_torch.cli.evaluate_classification, "
            "rtdm_tpu_torch.quant.calibrate, rtdm_tpu_torch.quant.int8, "
            "rtdm_tpu_torch.eval.classification, "
            "rtdm_tpu_torch.export.detector, rtdm_tpu_torch.models.darknet, "
            "rtdm_tpu_torch.models.yolov5, rtdm_tpu_torch.ops.nms, "
            "rtdm_tpu_torch.ops.yolo, rtdm_tpu_torch.data.odder, "
            "rtdm_tpu_torch.eval.detection, rtdm_tpu_torch.cli.aider_train, "
            "rtdm_tpu_torch.train.trainer, rtdm_tpu_torch.train.checkpoint, "
            "rtdm_tpu_torch.utils.experiment_log, "
            "rtdm_tpu_torch.cli.yolo_train, rtdm_tpu_torch.cli.make_synth, "
            "rtdm_tpu_torch.ops.boxes, rtdm_tpu_torch.train.yolo_loss, "
            "rtdm_tpu_torch.train.ema, rtdm_tpu_torch.train.autoanchor, "
            "rtdm_tpu_torch.train.evolve, rtdm_tpu_torch.train.schedules, "
            "rtdm_tpu_torch.data.yolo_augment, rtdm_tpu_torch.data.synth, "
            "rtdm_tpu_torch.utils.yaml_io, rtdm_tpu_torch.utils.plots, "
            "rtdm_tpu_torch.utils.summary, rtdm_tpu_torch.data.native_io, "
            "rtdm_tpu_torch.cli.create_splits, rtdm_tpu_torch.cli.gen_txts, "
            "rtdm_tpu_torch.cli.img_verify, rtdm_tpu_torch.cli.log_dataset, "
            "rtdm_tpu_torch.core.mesh, rtdm_tpu_torch.parallel, "
            "rtdm_tpu_torch.models.torch_import, "
            "rtdm_tpu_torch.export.serialize, "
            "rtdm_tpu_torch.utils.layer_profile, "
            "rtdm_tpu_torch.cli.export_model, "
            "rtdm_tpu_torch.cli.profile_model, "
            "rtdm_tpu_torch.cli.pth_to_weights, "
            "rtdm_tpu_torch.cli.build_int8_engines, "
            "rtdm_tpu_torch.models.packed, rtdm_tpu_torch.utils.downloads; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]; print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
