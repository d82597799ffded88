"""Two-stage disaster-management cascade on the card.

Counterpart of ``rtdm_tpu/cli/cascade_stream.py``, where the whole cascade
is one jitted XLA program per frame batch:

    uint8 letterboxed frame -> [ detector: /255 -> darknet/v5 -> decode
                                 -> NMS (max_det 100, top_k 256) ]  and,
    from the same device buffer -> [ classifier: resize to its input size
                                     -> ImageNet normalize -> network ]

so a frame is uploaded once and the host gets back (scene_probs, boxes,
count). Here the two branches are enqueued one after the other on the
card from that one upload, rounded as the compiled JAX program rounds
them:

- the detector is the unfused model of ``load_detection_model`` (no
  conv+BN folding, unlike a saved ``Detector`` engine), its parameters
  cast to the compute dtype, its input ``xf * fp32(1/255)`` cast to it,
  run as ``export/detector.py::Detector`` runs a network, then decode and
  greedy NMS;
- the classifier input is ``resize_bilinear`` of the fp32 frame
  (``jax.image.resize`` bilinear: antialiased on a downscale), then
  ``fma(small, fp32(1/255), -mean) * fp32(1/std)`` as XLA compiles
  ``(small / 255 - mean) / std`` (``data/aider.py::normalize_batch``),
  cast to the compute dtype; probabilities come back in fp32.

Precisions: fp32 or bf16 (``fp16`` and ``int8`` compute in bf16, as the
JAX CLI maps them). TF32 is off for every fp32 product (the resize, an
fp32 network, decode and NMS) and on for a bf16 network's fp32 convs of
bf16 values, each branch under ``core/precision.py::tf32``.

Run: python -m rtdm_tpu_torch.cli.cascade_stream --source <dir|video> \
         --det-cfg model.cfg --det-weights det.npz \
         --cls-model squeeze-ernet --cls-weights cls.npz [--device cpu]
"""

from __future__ import annotations

import argparse
import os
from typing import Tuple

import numpy as np
import torch

from rtdm_tpu_torch.core.precision import tf32


class Cascade:
    """Callable over uint8 letterboxed NHWC frames (at most ``batch``) ->
    device (probs (n, classes) fp32, det (n, 100, 6), count (n,))."""

    def __init__(self, det_cfg: str, det_weights, cls_model_name: str,
                 cls_weights, img_size: int, conf: float, iou: float,
                 quant: str = "bf16", batch: int = 1, device="cuda"):
        from rtdm_tpu_torch.data.aider import IMAGENET_MEAN, IMAGENET_STD
        from rtdm_tpu_torch.export.detector import (Detector, DetectorSpec,
                                                    load_detection_model)
        from rtdm_tpu_torch.export.engine import EngineSpec, load_model
        from rtdm_tpu_torch.models.ernet import input_size_for
        from rtdm_tpu_torch.models.io import load_variables

        quant = {"int8": "bf16", "fp16": "bf16"}.get(quant, quant)
        model, variables, heads = load_detection_model(det_cfg, det_weights,
                                                       img_size)
        spec = DetectorSpec(cfg_name=os.path.basename(det_cfg),
                            img_size=img_size, conf_thres=conf,
                            iou_thres=iou, max_det=100, top_k=256,
                            quant=quant, fuse=False)
        self.detector = Detector(model, variables, spec, batch, heads,
                                 device=device)
        self.device = self.detector.device
        self.dtype = self.detector.dtype
        self.cls_size = input_size_for(cls_model_name)
        self.classifier = load_model(
            EngineSpec(cls_model_name, quant, batch, self.cls_size),
            load_variables(cls_weights), self.device, self.dtype)
        self._mean = torch.as_tensor(IMAGENET_MEAN, device=self.device)
        self._inv_std = 1.0 / torch.as_tensor(IMAGENET_STD,
                                              device=self.device)

    def classifier_input(self, u8: torch.Tensor) -> torch.Tensor:
        """Device uint8 NHWC letterboxed frames -> the classifier's input."""
        from rtdm_tpu_torch.export.detector import resize_bilinear
        small = resize_bilinear(u8.float(), (self.cls_size, self.cls_size))
        inv255 = torch.full((), np.float32(1.0) / 255, device=self.device)
        x = torch.addcmul(-self._mean, small, inv255) * self._inv_std
        return x.to(self.dtype)

    @torch.inference_mode()
    def forward(self, u8: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Device uint8 NHWC (the engine batch) -> device outputs."""
        det, count = self.detector.forward(u8)
        with tf32(False):
            x = self.classifier_input(u8)
        with tf32(self.dtype != torch.float32):
            probs = self.classifier(x, apply_softmax=True).float()
        return probs, det, count

    def __call__(self, frames_u8):
        """Up to ``batch`` uint8 frames -> device (probs, det, count),
        sliced to the frames given."""
        x, n = self.detector._upload(frames_u8)
        probs, det, count = self.forward(x)
        return probs[:n], det[:n], count[:n]


# the JAX package's name for it
build_cascade = Cascade


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Classifier + detector cascade stream on the card")
    p.add_argument("--source", required=True)
    p.add_argument("--video-looping", action="store_true",
                   help="replay a finite source forever (reference camera "
                        "--video_looping)")
    p.add_argument("--width", type=int, default=0,
                   help="capture resize width (reference --do_resize)")
    p.add_argument("--height", type=int, default=0)
    p.add_argument("--det-cfg", required=True,
                   help="darknet .cfg or v5 .yaml")
    p.add_argument("--det-weights", help=".npz, .pt or .weights weights "
                   "(else a fresh init)")
    p.add_argument("--cls-model", default="squeeze-ernet")
    p.add_argument("--cls-weights", required=True)
    p.add_argument("--img-size", type=int, default=416)
    p.add_argument("--conf-thres", type=float, default=0.3)
    p.add_argument("--iou-thres", type=float, default=0.45)
    p.add_argument("--quant", default="bf16",
                   choices=["fp32", "bf16", "fp16"])
    p.add_argument("--names", help=".names file")
    p.add_argument("--save-dir")
    p.add_argument("--max-frames", type=int, default=0)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)

    from rtdm_tpu_torch.cli.yolo_detect import draw_detections
    from rtdm_tpu_torch.data.camera import FrameSource, is_live_source
    from rtdm_tpu_torch.data.odder import letterbox_image, load_names
    from rtdm_tpu_torch.models.ernet import CLASS_NAMES
    from rtdm_tpu_torch.ops.nms import scale_coords
    from rtdm_tpu_torch.utils.profiler import FpsMeter, StepTimer

    names = load_names(args.names) if args.names else ["person", "vehicle"]
    fn = build_cascade(args.det_cfg, args.det_weights, args.cls_model,
                       args.cls_weights, args.img_size, args.conf_thres,
                       args.iou_thres, args.quant, device=args.device)

    src = FrameSource.open(
        int(args.source) if args.source.isdigit() else args.source,
        loop=args.video_looping,
        width=args.width, height=args.height).start()
    fps = FpsMeter()
    timer = StepTimer()
    if args.save_dir:
        os.makedirs(args.save_dir, exist_ok=True)
    n = 0
    bounded = args.max_frames > 0 or not (is_live_source(args.source)
                                          or args.video_looping)
    results = []
    try:
        for frame in src:
            boxed, _, _ = letterbox_image(frame, args.img_size)
            timer.start()
            probs, det, count = fn(boxed[None])
            probs = probs.cpu().numpy()[0]
            det = det.cpu()
            timer.stop()
            k = int(count[0])
            det_scaled = scale_coords(det, (args.img_size, args.img_size),
                                      tuple(frame.shape[:2]))[0, :k].numpy()
            scene = CLASS_NAMES[int(np.argmax(probs))]
            cur = fps.tick()
            if bounded:
                results.append((scene, det_scaled))
            if args.save_dir:
                from PIL import Image, ImageDraw
                annotated = draw_detections(frame, det_scaled, names)
                im = Image.fromarray(annotated)
                d = ImageDraw.Draw(im)
                d.text((4, 4), f"{scene} | {cur:.1f} FPS",
                       fill=(255, 255, 0))
                im.save(os.path.join(args.save_dir, f"frame_{n:05d}.jpg"))
            if n % 10 == 0:
                print(f"frame {n}: scene={scene} victims/vehicles={k} "
                      f"({timer.times[-1] * 1e3:.1f} ms)")
            n += 1
            if args.max_frames and n >= args.max_frames:
                break
    finally:
        src.stop()
    print(f"frames {n}  cascade {timer.mean * 1e3:.2f} ms/frame "
          f"({1 / max(timer.mean, 1e-9):.1f} FPS)")
    return results


if __name__ == "__main__":
    main()
