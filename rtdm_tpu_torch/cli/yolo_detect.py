"""YOLO folder/image/stream inference CLI.

Counterpart of ``rtdm_tpu/cli/yolo_detect.py``, every flag of it plus
``--device`` (``cuda`` by default; ``cpu`` runs the port's CPU path).
Parity with yolov3/detect.py:9-155 and tensorrt_inference/trt_yolo.py's
--detect-images mode (:54-127): letterbox -> one fused device program
(forward+decode+NMS) -> un-letterbox coords -> annotated images + per-image
detection txts in mAP-tool format (`cls conf x1 y1 x2 y2`). Non-file
sources (video/webcam/rtsp/.streams) run the camera loop with an EMA FPS
readout — trt_yolo.py's loop_and_detect (:130-162) / v5 detect.py's
webcam branch.

Run: python -m rtdm_tpu_torch.cli.yolo_detect --engine
         artifacts/engines/yolov4-tiny-mini_int8 --source docs/examples
         --output out/
"""

from __future__ import annotations

import argparse
import glob
import os
import sys
import time

IMG_EXTS = (".jpg", ".jpeg", ".png", ".bmp")

COLORS = [(255, 64, 64), (64, 160, 255), (64, 224, 64), (255, 192, 32),
          (192, 64, 255), (32, 224, 224)]


def list_images(source: str):
    if os.path.isdir(source):
        return sorted(p for p in glob.glob(os.path.join(source, "*"))
                      if p.lower().endswith(IMG_EXTS))
    return [source]


def load_weights_for_cfg(cfg_path: str, weights: str, img_size: int,
                         num_classes=None):
    """Model+weights for a darknet .cfg or v5 .yaml (shared CLI loader)."""
    from rtdm_tpu_torch.export.detector import load_detection_model

    model, variables, _ = load_detection_model(cfg_path, weights, img_size,
                                               num_classes)
    return model, variables


def draw_detections(img, dets, names, line_thickness: int = 2,
                    hide_labels: bool = False, hide_conf: bool = False):
    """Annotate HWC uint8 with boxes (PIL, no cv2 dependency).
    line_thickness / hide_labels / hide_conf mirror yolov5/detect.py's
    --line-thickness / --hide-labels / --hide-conf draw options
    (detect.py:174-176 via plot_one_box)."""
    from PIL import Image, ImageDraw

    im = Image.fromarray(img)
    d = ImageDraw.Draw(im)
    for x1, y1, x2, y2, conf, cls in dets:
        color = COLORS[int(cls) % len(COLORS)]
        d.rectangle([x1, y1, x2, y2], outline=color,
                    width=max(int(line_thickness), 1))
        if not hide_labels:
            name = names[int(cls)] if int(cls) < len(names) else str(int(cls))
            label = name if hide_conf else f"{name} {conf:.2f}"
            d.text((x1 + 2, max(y1 - 12, 0)), label, fill=color)
    import numpy as np
    return np.asarray(im)


def save_crops(img, dets, names, crops_dir: str, stem: str,
               pad_gain: float = 1.02, pad_px: float = 10.0):
    """Crop each detection into crops/<class>/<stem>_<k>.jpg — the
    --save-crop path (yolov5/detect.py:165 via save_one_box, which pads
    the box by gain 1.02 + 10px before cropping)."""
    import numpy as np
    from PIL import Image

    h, w = img.shape[:2]
    for k, (x1, y1, x2, y2, conf, cls) in enumerate(dets):
        cx, cy = (x1 + x2) / 2.0, (y1 + y2) / 2.0
        bw = (x2 - x1) * pad_gain + pad_px
        bh = (y2 - y1) * pad_gain + pad_px
        xa = int(max(np.floor(cx - bw / 2), 0))
        ya = int(max(np.floor(cy - bh / 2), 0))
        xb = int(min(np.ceil(cx + bw / 2), w))
        yb = int(min(np.ceil(cy + bh / 2), h))
        if xb <= xa or yb <= ya:
            continue
        name = names[int(cls)] if int(cls) < len(names) else str(int(cls))
        d = os.path.join(crops_dir, name)
        os.makedirs(d, exist_ok=True)
        Image.fromarray(img[ya:yb, xa:xb]).save(
            os.path.join(d, f"{stem}_{k}.jpg"))


def main(argv=None):
    p = argparse.ArgumentParser(description="YOLO detection")
    p.add_argument("--cfg", help="darknet .cfg or yolov5 .yaml")
    p.add_argument("--engine", help="saved detector engine dir "
                   "(build with build_engine --cfg)")
    p.add_argument("--weights", help=".npz, .pt/.pth (v5 or the darknet "
                   "fork) or darknet .weights")
    p.add_argument("--source", required=True,
                   help="image file | directory | video file | webcam id | "
                        "rtsp:// | .streams list (live sources run the "
                        "trt_yolo.py loop_and_detect / v5 detect.py webcam "
                        "path with an EMA FPS readout)")
    p.add_argument("--max-frames", type=int, default=0,
                   help="stop a stream after N frames (0 = run to end)")
    p.add_argument("--video-looping", action="store_true",
                   help="replay a finite stream forever (reference camera "
                        "--video_looping)")
    p.add_argument("--width", type=int, default=0,
                   help="capture resize width (reference --do_resize)")
    p.add_argument("--height", type=int, default=0)
    p.add_argument("--output", default="runs/detect")
    p.add_argument("--project", default=None,
                   help="v5 run-dir convention: outputs go to "
                        "project/name{,2,3...} instead of --output "
                        "(yolov5/detect.py:171-173)")
    p.add_argument("--name", default=None, help="run name under --project")
    p.add_argument("--exist-ok", action="store_true",
                   help="reuse project/name without incrementing")
    p.add_argument("--fourcc", default="mp4v",
                   help="codec for the annotated output video written for "
                        "video-file sources (yolov3/detect.py:131-137)")
    p.add_argument("--img-size", type=int, default=416)
    p.add_argument("--conf-thres", type=float, default=0.25)
    p.add_argument("--iou-thres", type=float, default=0.45)
    p.add_argument("--names", help=".names file")
    p.add_argument("--quant", default="bf16",
                   choices=["fp32", "bf16", "fp16", "int8"])
    p.add_argument("--nms-method", default="greedy",
                   choices=["greedy", "merge", "soft"],
                   help="NMS variant (vision_batch/merge/soft analogues)")
    p.add_argument("--augment", action="store_true",
                   help="test-time augmentation (multi-scale + flip)")
    p.add_argument("--rect", action="store_true",
                   help="letterbox each frame to its minimal stride-"
                        "multiple rectangle instead of the full square "
                        "(the reference detect path's letterbox auto=True,"
                        " datasets.py:599-630): best for video/webcam/"
                        "rtsp sources (constant shape, ~25%% less conv "
                        "compute on 16:9)")
    p.add_argument("--save-txt", action="store_true",
                   help="write per-image detection txts (--txt-format)")
    p.add_argument("--txt-format", default="map", choices=["map", "yolo"],
                   help="txt row format: 'map' = `cls conf x1 y1 x2 y2` "
                        "(mAP-tool format, trt_yolo.py convention) or "
                        "'yolo' = normalized `cls cx cy w h [conf]` under "
                        "labels/ (yolov5/detect.py:139-143)")
    p.add_argument("--save-conf", action="store_true",
                   help="append the confidence column to 'yolo'-format "
                        "label txts (detect.py:164)")
    p.add_argument("--save-crop", action="store_true",
                   help="save padded detection crops to "
                        "crops/<class>/<stem>_<k>.jpg (detect.py:165)")
    p.add_argument("--nosave", action="store_true",
                   help="skip the annotated output images (detect.py:166)")
    p.add_argument("--classes", nargs="+", type=int, metavar="C",
                   help="keep only these class ids (detect.py:167)")
    p.add_argument("--agnostic-nms", action="store_true",
                   help="class-agnostic suppression (detect.py:168)")
    p.add_argument("--max-det", type=int, default=300,
                   help="max detections per image (yolov5/detect.py:160)")
    p.add_argument("--line-thickness", type=int, default=2,
                   help="box outline width px (yolov5/detect.py:174)")
    p.add_argument("--hide-labels", action="store_true")
    p.add_argument("--hide-conf", action="store_true")
    p.add_argument("--classify", metavar="MODEL",
                   help="second-stage classifier veto over detection "
                        "crops (apply_classifier, detect.py:43-44): "
                        "classifier model name, e.g. squeeze-ernet")
    p.add_argument("--classifier-weights",
                   help=".pt state_dict | .npz for --classify")
    p.add_argument("--class-map", nargs="+", metavar="DET:CLS",
                   help="detector-class -> classifier-class id pairs for "
                        "--classify, e.g. `0:3 1:4` (required when the two "
                        "label spaces differ; without it the veto compares "
                        "raw ids)")
    p.add_argument("--single-label", action="store_true",
                   help="best-class-only rows (the reference's detect path "
                   "defaults to multi-label whenever nc>1, utils.py:488)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    from rtdm_tpu_torch.utils.checks import check_img_size
    args.img_size = check_img_size(args.img_size)
    # rect incompatibilities fail before any model loads
    if args.rect and args.augment:
        raise SystemExit("--rect and --augment are mutually exclusive "
                         "(the TTA pyramid is square)")
    if args.rect and args.classify:
        raise SystemExit("--rect and --classify are mutually exclusive "
                         "(the second stage is built for the square "
                         "frame)")
    if args.project is not None or args.name is not None:
        from rtdm_tpu_torch.utils.paths import increment_path
        args.output = increment_path(
            os.path.join(args.project or "runs/detect", args.name or "exp"),
            exist_ok=args.exist_ok)
        print(f"run dir: {args.output}")

    import numpy as np

    from rtdm_tpu_torch.data.odder import (default_names, letterbox_image,
                                           load_names)
    from rtdm_tpu_torch.export.detector import Detector, DetectorSpec
    from rtdm_tpu_torch.ops.nms import scale_coords

    if args.engine:
        from rtdm_tpu_torch.export.detector import load_detector
        # NMS-shaping flags the user explicitly moved off their defaults
        # override the engine's baked spec (an engine stores the build-time
        # thresholds; the reference's TrtYOLO likewise takes conf_thres at
        # run time, trt_yolo.py:38-40) — without this, `--engine --classes 0`
        # would silently drop the filter
        overrides = {}
        for flag, field in (("conf_thres", "conf_thres"),
                            ("iou_thres", "iou_thres"),
                            ("nms_method", "nms_method"),
                            ("max_det", "max_det"),
                            ("augment", "tta")):
            if getattr(args, flag) != p.get_default(flag):
                overrides[field] = getattr(args, flag)
        if args.single_label:
            overrides["multi_label"] = False
        if args.agnostic_nms:
            overrides["class_agnostic"] = True
        if args.classes:
            overrides["classes"] = tuple(args.classes)
        # the detect loop feeds ONE letterboxed frame at a time, so the
        # engine loads at batch 1 — a batch-256 engine would pad and run
        # 256 rows per frame (256x the compute and H2D)
        detector = load_detector(args.engine, device=args.device,
                                 spec_overrides=overrides, batch_size=1)
        args.img_size = detector.spec.img_size
        if args.rect and detector.spec.tta:
            # the engine itself may bake TTA (spec.json tta: true) even
            # without --augment on this command line
            raise SystemExit("--rect is incompatible with this engine: "
                             "it was built with TTA (square pyramid)")
    elif args.cfg:
        model, variables = load_weights_for_cfg(args.cfg, args.weights,
                                                args.img_size)
        spec = DetectorSpec(cfg_name=os.path.basename(args.cfg),
                            img_size=args.img_size,
                            conf_thres=args.conf_thres,
                            iou_thres=args.iou_thres, quant=args.quant,
                            tta=args.augment, nms_method=args.nms_method,
                            multi_label=not args.single_label,
                            max_det=args.max_det,
                            class_agnostic=args.agnostic_nms,
                            classes=(tuple(args.classes)
                                     if args.classes else None))
        if spec.quant == "int8":
            # no --calib-dir flow here: this builds WEIGHT-ONLY QDQ (no
            # activation scales), which matches no deployable calibrated
            # int8 engine — point users at build_engine for the real thing
            print("warning: --quant int8 from --cfg is weight-only QDQ "
                  "(uncalibrated activations); build a calibrated engine "
                  "with cli.build_engine --calib-dir and pass --engine",
                  file=sys.stderr)
        detector = Detector(model, variables, spec, device=args.device)
    else:
        raise SystemExit("provide --cfg or --engine")
    names = (load_names(args.names) if args.names
             else default_names(detector.num_classes))
    second = None
    if args.classify:
        from rtdm_tpu_torch.export.second_stage import build_second_stage
        class_map = None
        if args.class_map:
            class_map = {}
            for pair in args.class_map:
                det_c, cls_c = pair.split(":")
                class_map[int(det_c)] = int(cls_c)
        second = build_second_stage(
            args.classify, args.classifier_weights,
            quant=args.quant if args.quant != "int8" else "bf16",
            class_map=class_map, device=args.device)

    os.makedirs(args.output, exist_ok=True)
    from PIL import Image

    from rtdm_tpu_torch.data.camera import VID_EXTS
    is_files = (os.path.isdir(args.source)
                or args.source.lower().endswith(IMG_EXTS))
    is_video = args.source.lower().endswith(VID_EXTS)
    vid_writer = [None]  # lazily opened cv2.VideoWriter for video sources

    def write_video_frame(annotated):
        # annotated video output for video sources, the reference's
        # save_path vid_writer branch (yolov3/detect.py:131-137: fourcc
        # codec, source fps, frame size from the first frame)
        import cv2
        if vid_writer[0] is None:
            cap = cv2.VideoCapture(args.source)
            fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
            cap.release()
            stem = os.path.splitext(os.path.basename(args.source))[0]
            path = os.path.join(args.output, f"{stem}.mp4")
            vid_writer[0] = cv2.VideoWriter(
                path, cv2.VideoWriter_fourcc(*args.fourcc),
                max(fps, 1.0), (annotated.shape[1], annotated.shape[0]))
            print(f"writing annotated video: {path}")
        vid_writer[0].write(annotated[:, :, ::-1])  # RGB -> BGR

    def frames():
        if is_files:
            for path in list_images(args.source):
                yield path, np.asarray(Image.open(path).convert("RGB"),
                                       np.uint8)
            return
        # live/stream path: camera loop with EMA FPS, the trt_yolo.py
        # loop_and_detect analogue (:130-162) / v5 detect.py webcam branch
        from rtdm_tpu_torch.data.camera import FrameSource
        src = FrameSource.open(
            int(args.source) if args.source.isdigit() else args.source,
            loop=args.video_looping, width=args.width,
            height=args.height).start()
        try:
            for i, frame in enumerate(src):
                yield f"frame_{i:05d}", frame
                if args.max_frames and i + 1 >= args.max_frames:
                    break
        finally:
            src.stop()

    # Unbounded live streams (--max-frames 0 on a webcam/rtsp/.streams
    # source or a looping video) must not accumulate per-frame state, or a
    # multi-hour run leaks one det array per frame; finite runs (file
    # lists, finite videos, --max-frames) keep the full list — it is the
    # CLI's return value.
    bounded = (is_files or args.max_frames > 0
               or (is_video and not args.video_looping))
    results = []
    fps_ema = 0.0
    dt = 0.0
    t_steady = 0.0  # cumulative time excluding the first (warm-up) frame
    n_frames = 0
    for path, img in frames():
        if args.rect:
            from rtdm_tpu_torch.data.odder import minimal_rect_shape
            target = minimal_rect_shape(img.shape[0], img.shape[1],
                                        args.img_size)
        else:
            target = args.img_size
        boxed, _, _ = letterbox_image(img, target)
        t0 = time.perf_counter()
        x, _ = detector._upload(boxed[None])
        det_d, count_d = detector.forward(x)
        if second is not None:  # apply_classifier veto (detect.py:78-79)
            det_d, count_d = second.veto(x, det_d, count_d)
        n = int(count_d[0])
        det = scale_coords(det_d[0, :n], tuple(boxed.shape[:2]),
                           tuple(img.shape[:2])).cpu().numpy()
        dt = time.perf_counter() - t0
        n_frames += 1
        if n_frames > 1:
            t_steady += dt
        if bounded:
            results.append((path, det))

        stem = (os.path.splitext(os.path.basename(path))[0] if is_files
                else path)
        if not args.nosave:
            annotated = draw_detections(img, det, names,
                                        args.line_thickness,
                                        args.hide_labels, args.hide_conf)
            if is_video:
                write_video_frame(annotated)
            else:
                Image.fromarray(annotated).save(
                    os.path.join(args.output, f"{stem}.jpg"))
        if args.save_crop:
            save_crops(img, det, names,
                       os.path.join(args.output, "crops"), stem)
        if args.save_txt and args.txt_format == "yolo":
            # normalized `cls cx cy w h [conf]` rows under labels/
            # (yolov5/detect.py:139-143)
            lab_dir = os.path.join(args.output, "labels")
            os.makedirs(lab_dir, exist_ok=True)
            h, w = img.shape[:2]
            with open(os.path.join(lab_dir, f"{stem}.txt"), "w") as f:
                for x1, y1, x2, y2, conf, cls in det:
                    row = (f"{int(cls):g} {(x1 + x2) / 2 / w:g} "
                           f"{(y1 + y2) / 2 / h:g} {(x2 - x1) / w:g} "
                           f"{(y2 - y1) / h:g}")
                    if args.save_conf:
                        row += f" {conf:g}"
                    f.write(row + "\n")
        elif args.save_txt:
            with open(os.path.join(args.output, f"{stem}.txt"), "w") as f:
                for x1, y1, x2, y2, conf, cls in det:
                    cname = (names[int(cls)] if int(cls) < len(names)
                             else str(int(cls)))
                    f.write(f"{cname} {conf:.4f} {x1:.1f} {y1:.1f} "
                            f"{x2:.1f} {y2:.1f}\n")
        if is_files:
            print(f"{path}: {n} detections ({dt * 1e3:.1f} ms)")
        else:
            # EMA FPS, the show_fps readout (trt_yolo.py:150-158 curr_fps
            # decay 0.95/0.05; display.py:26 draws it on-frame)
            inst = 1.0 / max(dt, 1e-9)
            fps_ema = inst if fps_ema == 0.0 else \
                0.95 * fps_ema + 0.05 * inst
            print(f"{path}: {n} detections ({dt * 1e3:.1f} ms, "
                  f"FPS {fps_ema:.1f})")
    if vid_writer[0] is not None:
        vid_writer[0].release()
    if n_frames > 1:
        steady = t_steady / (n_frames - 1)  # excludes the warm-up frame
        print(f"avg {steady * 1e3:.1f} ms/frame ({1 / steady:.1f} FPS)")
    return results


if __name__ == "__main__":
    main()
