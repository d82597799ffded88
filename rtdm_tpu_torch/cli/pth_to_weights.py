"""Convert detector weights between ``.npz``, torch ``.pt`` and darknet
``.weights``.

Counterpart of ``rtdm_tpu/cli/pth_to_weights.py`` (the reference's
yolov3/pth_to_weights.py): reads an ``.npz``, the darknet fork's ``.pt``
or a ``.weights`` file for a darknet ``.cfg``
(``export/detector.py::load_detection_model``, which opens only the path
it is given) and writes a darknet ``.weights`` file or an ``.npz``. Runs
on the host; no device is involved.

Run: python -m rtdm_tpu_torch.cli.pth_to_weights --cfg x.cfg \\
         --input best.npz --output best.weights
"""

from __future__ import annotations

import argparse


def main(argv=None):
    p = argparse.ArgumentParser(description="weights format converter")
    p.add_argument("--cfg", required=True, help="darknet .cfg")
    p.add_argument("--input", required=True, help=".npz | .pt | .weights")
    p.add_argument("--output", required=True, help=".weights | .npz")
    p.add_argument("--img-size", type=int, default=416)
    args = p.parse_args(argv)

    from rtdm_tpu_torch.export.detector import load_detection_model
    from rtdm_tpu_torch.models.darknet import save_darknet_weights
    from rtdm_tpu_torch.models.io import save_variables

    if not args.output.endswith((".weights", ".npz")):
        raise SystemExit(f"unsupported output format: {args.output}")
    model, variables, _ = load_detection_model(args.cfg, args.input,
                                               args.img_size)
    if args.output.endswith(".weights"):
        save_darknet_weights(variables, model.cfg_text, args.output)
    else:
        save_variables(args.output, variables)
    print(f"{args.input} -> {args.output}")
    return args.output


if __name__ == "__main__":
    main()
