"""JAX reference logits for the PyTorch/CUDA port.

Writes ``tests/goldens/torch_port/classifier_logits.npz``: the JAX fp32
engine's logits (``with_softmax=False``) of the three classifiers, built
from the committed ``artifacts/engines/<model>_bf16/params.npz``, on the 10
example JPEGs in ``docs/examples/``, together with the preprocessed uint8
frames they were computed on; and
``tests/goldens/torch_port/classifier_int8_logits.npz``: the JAX int8
engines' logits (``with_softmax=False``) on the same frames, each built
from the committed ``artifacts/engines/<model>_int8`` directory with its
``act_scales.npz``. ``chip_smoke.py`` reads both files as plain data,
which holds a run on the card against the reference without JAX there;
``tests/test_torch_engine.py`` regenerates them in memory and checks that
they are current.

Regenerate: JAX_PLATFORMS=cpu python -m tests.torch_port_goldens
"""

from __future__ import annotations

import json
import os
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "tests" / "goldens" / "torch_port" / "classifier_logits.npz"
GOLDEN_INT8 = GOLDEN.with_name("classifier_int8_logits.npz")
MODELS = ("squeeze-ernet", "squeeze-redconv", "ernet")
EXAMPLES = tuple(sorted((ROOT / "docs" / "examples").glob("*.jpg")))
GOLDEN_BATCH = 16


def image_size(model: str) -> int:
    return 240 if model == "ernet" else 140


def params_path(model: str) -> str:
    return str(ROOT / "artifacts" / "engines" / f"{model}_bf16" / "params.npz")


def int8_dir(model: str) -> Path:
    return ROOT / "artifacts" / "engines" / f"{model}_int8"


def example_frames(size: int) -> np.ndarray:
    """The examples through the JAX package's eval transform, (10,s,s,3)."""
    from rtdm_tpu.cli.aider_predict import load_image_rgb, preprocess
    return np.concatenate([preprocess(load_image_rgb(str(p)), size)
                           for p in EXAMPLES])


def jax_logits(model: str, quant: str, frames: np.ndarray) -> np.ndarray:
    """Logits of the JAX engine at ``quant`` on ``frames``."""
    from rtdm_tpu.export.engine import Engine, EngineSpec
    from rtdm_tpu.models.io import load_variables
    spec = EngineSpec(model, quant, GOLDEN_BATCH, image_size(model),
                      with_softmax=False)
    return Engine(spec, load_variables(params_path(model)))(frames)


def jax_int8_logits(model: str, frames: np.ndarray) -> np.ndarray:
    """Logits of the JAX int8 engine of ``int8_dir(model)`` (its params and
    act_scales) on ``frames``."""
    from rtdm_tpu.export.engine import Engine, EngineSpec
    from rtdm_tpu.models.io import load_variables
    d = int8_dir(model)
    spec = json.loads((d / "spec.json").read_text())
    spec.update(batch_size=GOLDEN_BATCH, with_softmax=False)
    with np.load(d / "act_scales.npz") as archive:
        scales = dict(archive)
    return Engine(EngineSpec(**spec), load_variables(str(d / "params.npz")),
                  scales)(frames)


def make_int8_golden() -> dict:
    out = {"names": np.array([p.name for p in EXAMPLES])}
    for model in MODELS:
        out[model] = jax_int8_logits(model, example_frames(image_size(model)))
    return out


def make_golden() -> dict:
    out = {"names": np.array([p.name for p in EXAMPLES])}
    for size in (140, 240):
        out[f"frames_{size}"] = example_frames(size)
    for model in MODELS:
        out[model] = jax_logits(model, "fp32",
                                out[f"frames_{image_size(model)}"])
    return out


def main() -> None:
    os.environ["RTDM_XLA_CACHE"] = "0"   # no persistent compile cache
    GOLDEN.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(GOLDEN, **make_golden())
    np.savez_compressed(GOLDEN_INT8, **make_int8_golden())
    print(f"wrote {GOLDEN} and {GOLDEN_INT8}")


if __name__ == "__main__":
    main()
