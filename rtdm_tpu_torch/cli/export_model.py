"""Model export CLI: a classifier or detector forward as a ``torch.export``
program (``.pt2``).

Counterpart of ``rtdm_tpu/cli/export_model.py`` (the reference's
generate_onnx.py): the classifier's normalize and forward (``--model`` and
``--weights``, fp32; or ``--engine DIR``, an engine directory's forward in
its own precision, its ACFF blocks the ``rtdm::acff_infer`` op) or the
detector's fp32 forward and ``decode_all`` (``--cfg`` and ``--weights``),
on uint8 NHWC frames, with ``--dynamic-batch`` a symbolic batch; then the
saved program is loaded and held to the eager forward
(``export/serialize.py::verify_export``). Runs on the card unless
``--device cpu``; the program runs on the device it was exported on. An
fp32 program is called with TF32 off (``core/precision.py::tf32``), as the
engines are.

Run: python -m rtdm_tpu_torch.cli.export_model --model squeeze-ernet \\
         --weights params.npz --output squeeze-ernet.pt2 [--dynamic-batch]
"""

from __future__ import annotations

import argparse
import os


def classifier_forward(args, device):
    """(forward of uint8 frames, image size) of the classifier that
    ``--engine`` or ``--model``/``--weights`` names."""
    from rtdm_tpu_torch.export.engine import Engine, build_engine

    if args.engine:
        engine = Engine.load(args.engine, device=device)
    else:
        from rtdm_tpu_torch.models.io import load_variables
        engine = build_engine(args.model or "squeeze-ernet",
                              load_variables(args.weights), "fp32",
                              batch_size=1, verify=False, device=device)
    if args.img_size not in (None, engine.spec.image_size):
        raise SystemExit(f"{engine.spec.model} takes "
                         f"{engine.spec.image_size}^2 frames")
    return engine._forward, engine.spec.image_size


def detector_forward(args, device):
    """(forward of uint8 frames: fp32 network, then ``decode_all``, image
    size) of ``--cfg``/``--weights``."""
    import torch

    from rtdm_tpu_torch.export.detector import load_detection_model
    from rtdm_tpu_torch.models.io import torch_state_dict_from_variables
    from rtdm_tpu_torch.ops.yolo import decode_all

    size = args.img_size or 416
    model, variables, heads = load_detection_model(args.cfg, args.weights,
                                                   size)
    model.load_state_dict(torch_state_dict_from_variables(variables))
    model = model.to(device).eval()

    def fwd(u8):
        return decode_all(model(u8.to(torch.float32) / 255.0), heads, size)
    return fwd, size


def main(argv=None):
    p = argparse.ArgumentParser(description="Export a model as a "
                                "torch.export program (.pt2)")
    p.add_argument("--model", help="classifier name (ernet family)")
    p.add_argument("--engine", help="classifier engine directory (its "
                   "precision) instead of --model/--weights")
    p.add_argument("--cfg", help="detector .cfg/.yaml instead of --model")
    p.add_argument("--weights", help="weights (.npz, .pt, .weights)")
    p.add_argument("--output", required=True, help=".pt2 path")
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--img-size", type=int, default=None)
    p.add_argument("--dynamic-batch", action="store_true")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    if args.output.endswith(".onnx"):
        raise SystemExit("ONNX export needs the onnx package, which is not "
                         "installed; write a .pt2 program")
    if not args.engine and not args.weights:
        raise SystemExit("--weights is required without --engine")

    import numpy as np
    import torch

    from rtdm_tpu_torch.core.device import resolve_device
    from rtdm_tpu_torch.core.precision import tf32
    from rtdm_tpu_torch.export.serialize import (export_program,
                                                 save_exported,
                                                 verify_export)

    device = resolve_device(args.device)
    fwd, size = (detector_forward(args, device) if args.cfg
                 else classifier_forward(args, device))
    example = torch.from_numpy(np.zeros((args.batch_size, size, size, 3),
                                        np.uint8)).to(device)
    with tf32(False):
        program = export_program(fwd, [example],
                                 dynamic_batch=args.dynamic_batch)
        out = save_exported(args.output, program)
        verify_export(out, [example], reference_fn=fwd)
    print(f"exported + verified: {out} "
          f"({os.path.getsize(out) / 1e6:.2f} MB, "
          f"dynamic_batch={args.dynamic_batch})")
    return out


if __name__ == "__main__":
    main()
