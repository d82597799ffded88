"""Engine-build CLI: a classifier's weights -> an engine directory.

Counterpart of the classifier branch of ``rtdm_tpu/cli/build_engine.py``:
model and precision, engine batch, a verification inference, and for int8
activation calibration on a directory of images (``--calib-dir``, up to
256 of ``*.jpg``/``*.jpeg``/``*.png`` through the eval transform,
``--calib-method`` percentile or entropy). The directory (``spec.json`` +
``params.npz`` [+ ``act_scales.npz``]) loads in both packages. Detector
engines (``--cfg``, ``--sealed``) wait for the detection slice. Builds
(and calibrates) on the card unless ``--device cpu``.

Run: python -m rtdm_tpu_torch.cli.build_engine --model squeeze-ernet \
         --weights artifacts/engines/squeeze-ernet_bf16/params.npz \
         --quant int8 --calib-dir docs/examples --output engines/se_int8
"""

from __future__ import annotations

import argparse
import glob
import os
import time


def load_calib_images(calib_dir: str, image_size: int, limit: int = 256):
    """Up to ``limit`` images of ``calib_dir`` (sorted by path) as uint8
    (N, size, size, 3) frames, through the eval transform."""
    import numpy as np
    from rtdm_tpu_torch.cli.aider_predict import load_image_rgb, preprocess

    paths = sorted(
        p for pat in ("*.jpg", "*.jpeg", "*.png")
        for p in glob.glob(os.path.join(calib_dir, pat)))[:limit]
    if not paths:
        raise FileNotFoundError(f"no calibration images in {calib_dir}")
    return np.concatenate(
        [preprocess(load_image_rgb(p), image_size) for p in paths], axis=0)


def main(argv=None):
    p = argparse.ArgumentParser(description="Build an rtdm_tpu_torch engine")
    p.add_argument("--model", default="squeeze-ernet",
                   choices=["ernet", "squeeze-ernet", "squeeze-redconv"])
    p.add_argument("--cfg", help="a detector's darknet .cfg / v5 .yaml "
                   "(detection slice, not ported yet)")
    p.add_argument("--weights", required=True, help="weights (.npz)")
    p.add_argument("--quant", default="bf16",
                   choices=["fp32", "bf16", "fp16", "int8"])
    p.add_argument("--batch-size", type=int, default=256,
                   help="engine max batch")
    p.add_argument("--calib-dir", help="calibration image dir (int8)")
    p.add_argument("--calib-method", default="percentile",
                   choices=["percentile", "entropy"])
    p.add_argument("--sealed", action="store_true",
                   help="int8 detector engines with int8 weight codes "
                   "(detection slice, not ported yet)")
    p.add_argument("--output", required=True, help="engine output dir")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)

    if args.cfg or args.sealed:
        raise SystemExit("--cfg and --sealed build detector engines, which "
                         "wait for the detection slice of the port")

    from rtdm_tpu_torch.export.engine import build_engine
    from rtdm_tpu_torch.models.ernet import input_size_for
    from rtdm_tpu_torch.models.io import load_variables

    variables = load_variables(args.weights)
    calib = None
    if args.quant == "int8":
        if not args.calib_dir:
            raise SystemExit("--calib-dir is required for int8 engines")
        calib = load_calib_images(args.calib_dir, input_size_for(args.model))
        print(f"calibrating on {calib.shape[0]} images "
              f"({args.calib_method})...")

    t0 = time.time()
    engine = build_engine(args.model, variables, quant=args.quant,
                          batch_size=args.batch_size, calib_images=calib,
                          calib_method=args.calib_method, device=args.device)
    print(f"engine built + verified in {time.time() - t0:.1f}s")
    engine.save(args.output)
    print(f"saved to {args.output} "
          f"(spec.json + params.npz"
          f"{' + act_scales.npz' if args.quant == 'int8' else ''})")
    return engine


if __name__ == "__main__":
    main()
