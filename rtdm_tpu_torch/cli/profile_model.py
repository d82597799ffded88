"""Per-layer profile of a v5 yaml model: time, GFLOPs and parameters.

Counterpart of ``rtdm_tpu/cli/profile_model.py`` (the reference's
``python models/yolo.py --cfg ... --profile``): builds the model (the
seeded init, or ``--weights``: a v5 ``.pt`` or an ``.npz``), runs it in
fp32 at ``--batch`` x ``--img-size``² and prints each layer's cost as
``utils/layer_profile.py`` measures it, on the card unless ``--device
cpu`` (CUDA events there, the host clock on the CPU).

Run: python -m rtdm_tpu_torch.cli.profile_model --cfg yolov5s.yaml \\
         [--img-size 416] [--batch 1] [--weights ckpt.pt] [--iters 10]
"""

from __future__ import annotations

import argparse


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--cfg", required=True, help="yolov5 .yaml")
    p.add_argument("--img-size", type=int, default=416)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--weights", help="optional v5 .pt or .npz weights")
    p.add_argument("--num-classes", type=int, default=None)
    p.add_argument("--iters", type=int, default=10,
                   help="timing repeats per prefix (best-of)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    if not args.cfg.endswith((".yaml", ".yml")):
        raise SystemExit("profile_model takes a v5 .yaml model")

    import torch

    from rtdm_tpu_torch.core.device import resolve_device
    from rtdm_tpu_torch.core.precision import tf32
    from rtdm_tpu_torch.export.detector import load_detection_model
    from rtdm_tpu_torch.models.io import torch_state_dict_from_variables
    from rtdm_tpu_torch.utils.layer_profile import (format_profile_table,
                                                    profile_v5_layers)

    device = resolve_device(args.device)
    model, variables, _ = load_detection_model(
        args.cfg, args.weights, args.img_size, args.num_classes)
    model.load_state_dict(torch_state_dict_from_variables(variables))
    model = model.to(device).eval()
    x = torch.zeros((args.batch, args.img_size, args.img_size, 3),
                    device=device)
    with tf32(False):
        rows = profile_v5_layers(model, x, iters=args.iters)
    print(format_profile_table(rows))
    return rows


if __name__ == "__main__":
    main()
