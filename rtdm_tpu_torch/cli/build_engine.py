"""Engine-build CLI: a classifier's or a detector's weights -> an engine
directory.

Counterpart of ``rtdm_tpu/cli/build_engine.py``. Classifiers: model and
precision, engine batch, a verification inference, and for int8
activation calibration on a directory of images (``--calib-dir``, up to
256 of ``*.jpg``/``*.jpeg``/``*.png`` through the eval transform,
``--calib-method`` percentile or entropy); the directory (``spec.json`` +
``params.npz`` [+ ``act_scales.npz``]) loads in both packages. Detectors
(``--cfg`` a darknet .cfg or a v5 .yaml; ``.npz``, ``.pt`` or ``.weights``
weights): ``--img-size``,
``--num-classes``, ``--conf-thres``, ``--iou-thres``, int8 calibration on
letterboxed frames, and ``--sealed`` int8 weight codes (``spec.json`` +
``model.txt`` + ``params.npz`` [+ ``act_scales.npz``]). Builds (and
calibrates) on the card unless ``--device cpu``.

Run: python -m rtdm_tpu_torch.cli.build_engine --model squeeze-ernet \
         --weights artifacts/engines/squeeze-ernet_bf16/params.npz \
         --quant int8 --calib-dir docs/examples --output engines/se_int8
     python -m rtdm_tpu_torch.cli.build_engine --cfg yolov4-tiny.cfg \
         --weights v4tiny.npz --quant int8 --sealed \
         --calib-dir docs/examples --output engines/v4tiny_int8
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


def load_detector_calib_images(calib_dir: str, img_size: int,
                               limit: int = 256):
    """Up to ``limit`` images of ``calib_dir`` (sorted by path),
    letterboxed to ``img_size``, as uint8 (N, s, s, 3). A directory of
    JPEGs goes through the native batch decode (one call for the set); a
    slot it fails, and every image of any other directory, takes PIL."""
    import numpy as np
    from rtdm_tpu_torch.cli.aider_predict import load_image_rgb
    from rtdm_tpu_torch.data import native_io
    from rtdm_tpu_torch.data.odder import letterbox_image

    paths = sorted(
        p for pat in ("*.jpg", "*.jpeg", "*.png")
        for p in glob.glob(os.path.join(calib_dir, pat)))[:limit]
    if not paths:
        raise FileNotFoundError(f"no calibration images in {calib_dir}")
    res = (native_io.decode_batch(paths, img_size)
           if all(p.lower().endswith((".jpg", ".jpeg")) for p in paths)
           else None)
    if res is None:
        return np.stack([letterbox_image(load_image_rgb(p), img_size)[0]
                         for p in paths])
    batch, _, _, _, ok = res
    for i in np.flatnonzero(~ok):
        batch[i] = letterbox_image(load_image_rgb(paths[i]), img_size)[0]
    return batch


def build_detector_engine(args):
    """The --cfg branch: build, save and report a detector engine."""
    from rtdm_tpu_torch.export.detector import (DetectorSpec, build_detector,
                                                save_detector)
    spec = DetectorSpec(cfg_name=os.path.basename(args.cfg),
                        img_size=args.img_size, conf_thres=args.conf_thres,
                        iou_thres=args.iou_thres, quant=args.quant,
                        calib_method=args.calib_method)
    calib = None
    if spec.quant == "int8":
        if not args.calib_dir:
            raise SystemExit("--calib-dir is required for int8 engines")
        calib = load_detector_calib_images(args.calib_dir, args.img_size)
        print(f"calibrating activations on {calib.shape[0]} images "
              f"({args.calib_method})...")
    t0 = time.time()
    det = build_detector(args.cfg, args.weights, spec,
                         batch_size=args.batch_size,
                         num_classes=args.num_classes, calib_images=calib,
                         device=args.device)
    print(f"detector engine built in {time.time() - t0:.1f}s")
    save_detector(det, args.output, sealed=args.sealed)
    print(f"saved to {args.output} (spec.json + model.txt + "
          f"{'SEALED int8 ' if args.sealed else ''}params.npz"
          f"{' + act_scales.npz' if spec.quant == 'int8' else ''})")
    return det


def main(argv=None):
    p = argparse.ArgumentParser(description="Build an rtdm_tpu_torch engine")
    p.add_argument("--model", default="squeeze-ernet",
                   choices=["ernet", "squeeze-ernet", "squeeze-redconv"])
    p.add_argument("--cfg", help="build a detector engine from this darknet "
                   ".cfg / v5 .yaml instead of a classifier")
    p.add_argument("--img-size", type=int, default=416,
                   help="detector input size")
    p.add_argument("--num-classes", type=int, default=None,
                   help="override the v5 yaml's class count")
    p.add_argument("--conf-thres", type=float, default=0.25)
    p.add_argument("--iou-thres", type=float, default=0.45)
    p.add_argument("--weights", required=True,
                   help="weights (.npz, torch .pt/.pth, darknet .weights)")
    p.add_argument("--quant", default="bf16",
                   choices=["fp32", "bf16", "fp16", "int8"])
    p.add_argument("--batch-size", type=int, default=256,
                   help="engine max batch")
    p.add_argument("--calib-dir", help="calibration image dir (int8)")
    p.add_argument("--calib-method", default="percentile",
                   choices=["percentile", "entropy"])
    p.add_argument("--sealed", action="store_true",
                   help="int8 detector engines: int8 weight codes + scales "
                   "with BN folded; the fp32 masters are not kept")
    p.add_argument("--output", required=True, help="engine output dir")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)

    if args.sealed:
        # fail fast, before a build the save would refuse
        if not args.cfg:
            raise SystemExit("--sealed applies to detector engines (--cfg); "
                             "classifier engines keep fp32 masters")
        if args.quant != "int8":
            raise SystemExit("--sealed requires --quant int8")
    if args.cfg:
        if not os.path.isfile(args.cfg):
            raise SystemExit(f"--cfg {args.cfg}: no such file")
        return build_detector_engine(args)

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
