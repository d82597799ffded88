"""Single-image AIDER prediction CLI.

Counterpart of ``rtdm_tpu/cli/aider_predict.py``: load an image, apply the
eval transform (resize 1.14x short side, center crop; ImageNet normalize on
the device), run the classifier, print class + softmax confidence.
``--engine`` loads an engine directory (``export/engine.py``), int8 ones
included; ``--weights x.npz --model m`` runs the raw weights through an
in-memory batch-1 engine at ``--quant`` (fp32 by default, with TF32 off;
int8 calibrates on the image itself, repeated 8 times, as the JAX CLI
does). Runs on the card unless ``--device cpu``.

Run: python -m rtdm_tpu_torch.cli.aider_predict --image x.jpg \
         --engine artifacts/engines/squeeze-ernet_bf16
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def load_image_rgb(path: str) -> np.ndarray:
    from PIL import Image
    with open(path, "rb") as f:
        return np.asarray(Image.open(f).convert("RGB"), np.uint8)


def preprocess(arr: np.ndarray, size: int) -> np.ndarray:
    """Eval transform on a HWC uint8 array -> (1,size,size,3) uint8."""
    from PIL import Image
    img = Image.fromarray(arr)
    w, h = img.size
    target = int(size * 1.14)
    if w <= h:
        nw, nh = target, max(int(round(h * target / w)), target)
    else:
        nh, nw = target, max(int(round(w * target / h)), target)
    img = img.resize((nw, nh), Image.BILINEAR)
    left, top = (nw - size) // 2, (nh - size) // 2
    img = img.crop((left, top, left + size, top + size))
    return np.array(img, np.uint8)[None]


def main(argv=None):
    p = argparse.ArgumentParser(description="AIDER single-image prediction")
    p.add_argument("--image", required=True)
    p.add_argument("--model", default="squeeze-ernet",
                   choices=["ernet", "squeeze-ernet", "squeeze-redconv"])
    p.add_argument("--weights", help="weights: an .npz variables archive")
    p.add_argument("--engine", help="engine directory (spec.json + params.npz)")
    p.add_argument("--quant", default=None,
                   choices=["fp32", "bf16", "fp16", "int8"],
                   help="with --weights: the in-memory engine's precision "
                        "(default fp32); with --engine: check that the "
                        "engine has it")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    if not args.engine and not args.weights:
        p.error("--weights is required unless --engine is given")

    from rtdm_tpu_torch.export.engine import Engine, build_engine
    from rtdm_tpu_torch.models.ernet import CLASS_NAMES

    if args.engine:
        from rtdm_tpu_torch.core.precision import normalized_quant
        engine = Engine.load(args.engine, device=args.device)
        if args.quant and engine.spec.normalized_quant() != \
                normalized_quant(args.quant):
            raise SystemExit(
                f"--quant {args.quant} does not match the engine's "
                f"precision ({engine.spec.quant}) — pass the matching "
                f"engine dir")
    else:
        from rtdm_tpu_torch.models.ernet import input_size_for
        from rtdm_tpu_torch.models.io import load_variables
        quant = args.quant or "fp32"
        calib = None
        if quant == "int8":
            calib = np.repeat(preprocess(load_image_rgb(args.image),
                                         input_size_for(args.model)), 8,
                              axis=0)
        engine = build_engine(args.model, load_variables(args.weights),
                              quant=quant, batch_size=1, calib_images=calib,
                              verify=False, device=args.device)
    image = preprocess(load_image_rgb(args.image), engine.spec.image_size)
    t0 = time.perf_counter()
    probs = np.asarray(engine(image)[0], np.float32)
    dt = time.perf_counter() - t0
    idx = int(np.argmax(probs))

    names = (CLASS_NAMES if len(probs) == len(CLASS_NAMES)
             else [f"class_{i}" for i in range(len(probs))])
    print(f"prediction: {names[idx]}  confidence: {probs[idx]:.4f}  "
          f"({dt * 1e3:.1f} ms on {args.device})")
    for i, name in enumerate(names):
        print(f"  {name:>20}: {probs[i]:.4f}")
    return idx


if __name__ == "__main__":
    sys.exit(0 if main() is not None else 1)
