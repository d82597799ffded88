"""Build calibrated int8 detector engines for several models in one run.

Counterpart of ``rtdm_tpu/cli/build_int8_engines.py`` (the reference's
tensorrt_inference/yolo/build_int8_engines.sh): every ``--cfgs`` model
becomes an int8 engine directory ``<output>/<stem>-int8-<img_size>``,
calibrated on the letterboxed images of ``--calib-dir`` through
``cli/build_engine.py`` (``load_detector_calib_images``) and
``export/detector.py`` (``build_detector``, ``save_detector``), on the card
unless ``--device cpu``. Each cfg's weights are
``--weights-dir/<stem>.{weights,pt,pth,npz}``, the first that exists, or
the seeded init with ``--allow-random``. Every cfg and weights file is
checked before the first engine is built.

Run: python -m rtdm_tpu_torch.cli.build_int8_engines \\
         --cfgs yolov4-tiny.cfg yolov5s.yaml --weights-dir weights/ \\
         --calib-dir calib_images/ --output engines/
"""

from __future__ import annotations

import argparse
import os
import time


def resolve_weights(weights_dir: str, stem: str):
    """``weights_dir/<stem>`` with the first of .weights, .pt, .pth, .npz
    that exists, or None."""
    for ext in (".weights", ".pt", ".pth", ".npz"):
        p = os.path.join(weights_dir, stem + ext)
        if os.path.exists(p):
            return p
    return None


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Batch-build calibrated int8 detector engines")
    p.add_argument("--cfgs", nargs="+", required=True,
                   help="darknet .cfg / v5 .yaml files")
    p.add_argument("--weights-dir", help="directory holding "
                   "<cfg-stem>.{weights,pt,pth,npz} per model")
    p.add_argument("--allow-random", action="store_true",
                   help="build with the seeded init when weights are "
                   "missing")
    p.add_argument("--img-size", type=int, default=416)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--calib-dir", required=True,
                   help="calibration image directory")
    p.add_argument("--calib-method", default="entropy",
                   choices=["percentile", "entropy"])
    p.add_argument("--output", default="engines",
                   help="parent directory of the engine directories")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)

    missing = [c for c in args.cfgs if not os.path.exists(c)]
    if missing:
        raise SystemExit(f"ERROR: cannot find cfg file(s): {missing}")
    plans = []
    for cfg in args.cfgs:
        stem = os.path.splitext(os.path.basename(cfg))[0]
        w = resolve_weights(args.weights_dir, stem) \
            if args.weights_dir else None
        if w is None and not args.allow_random:
            raise SystemExit(
                f"ERROR: no weights for {stem} in {args.weights_dir!r} "
                f"(pass --allow-random for smoke builds)")
        plans.append((cfg, stem, w))

    from rtdm_tpu_torch.cli.build_engine import load_detector_calib_images
    from rtdm_tpu_torch.export.detector import (DetectorSpec, build_detector,
                                                save_detector)

    calib = load_detector_calib_images(args.calib_dir, args.img_size)
    print(f"calibration set: {calib.shape[0]} images ({args.calib_method})")
    built = []
    for cfg, stem, w in plans:
        name = f"{stem}-int8-{args.img_size}"
        print(f"\n=== {name} ===")
        spec = DetectorSpec(cfg_name=os.path.basename(cfg),
                            img_size=args.img_size, quant="int8",
                            calib_method=args.calib_method)
        t0 = time.time()
        det = build_detector(cfg, w, spec, batch_size=args.batch_size,
                             calib_images=calib, device=args.device)
        out = os.path.join(args.output, name)
        save_detector(det, out)
        print(f"built in {time.time() - t0:.1f}s -> {out} "
              f"(weights: {w or 'RANDOM INIT'})")
        built.append(out)
    print(f"\nDone. {len(built)} int8 engines under {args.output}")
    return built


if __name__ == "__main__":
    main()
