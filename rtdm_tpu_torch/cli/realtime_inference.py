"""Real-time classifier streaming CLI.

Counterpart of ``rtdm_tpu/cli/realtime_inference.py`` (the reference's
real-time-inference.py:23-221: webcam or video loop, preprocess -> infer
-> class + FPS overlay, avg/min/max FPS report). The host only resizes
uint8 frames (cv2 ``INTER_LINEAR``, as the JAX CLI does) and uploads them;
/255, the ImageNet normalize, the forward and the softmax run on the card
in the engine (``export/engine.py``: with ``--engine`` a saved engine
directory, else ``--weights`` and ``--model`` built into an in-memory
engine at ``--quant``, int8 meaning bf16 as in the JAX CLI, at the batch
of ``--batch``, the tail batch zero-padded). Batches are double-buffered:
batch k+1 is enqueued before batch k is copied back.

``--power`` reports energy per frame from ``utils/profiler.py``'s
``PowerMonitor``: busy time x the card's power limit. ``--data-parallel``
shards each engine batch over the ranks of the process group
(``core/mesh.py::data_parallel_mesh``: ``torchrun``, one rank a card;
without a launcher one rank, and nothing changes), every rank reading the
same frames; the tail batch is padded to the full batch as always, and the
raw-weights path needs ``--batch`` to divide over the ranks. ``main``
returns a
dict: frames, the FPS and ms/batch report, mJ/frame with ``--power``, and
for a bounded source each frame's (class index, confidence).

Run: python -m rtdm_tpu_torch.cli.realtime_inference --source video.mp4 \
         --engine artifacts/engines/squeeze-ernet_bf16 [--device cpu]
"""

from __future__ import annotations

import argparse
import collections
import os
import time


def main(argv=None):
    p = argparse.ArgumentParser(description="Real-time AIDER classification")
    p.add_argument("--source", "--video", dest="source", required=True,
                   help="webcam id | /dev/videoN | rtsp:// | video file | "
                        "image dir (--video is the reference alias, "
                        "real-time-inference.py:34)")
    p.add_argument("--video-looping", action="store_true",
                   help="replay a finite source forever (reference "
                        "camera --video_looping)")
    p.add_argument("--width", type=int, default=0,
                   help="capture resize width (with --height; reference "
                        "--do_resize --width)")
    p.add_argument("--height", type=int, default=0,
                   help="capture resize height (with --width)")
    p.add_argument("--model", default="squeeze-ernet",
                   choices=["ernet", "squeeze-ernet", "squeeze-redconv"])
    p.add_argument("--weights")
    p.add_argument("--engine", help="saved engine dir (TRT analogue)")
    p.add_argument("--quant", default="bf16",
                   choices=["fp32", "bf16", "fp16", "int8"])
    p.add_argument("--batch", type=int, default=1,
                   help="micro-batch frames before dispatch")
    p.add_argument("--max-frames", type=int, default=0,
                   help="stop after N frames (0 = run to end)")
    p.add_argument("--save-dir", help="write annotated frames here")
    p.add_argument("--power", action="store_true",
                   help="report modelled energy per frame")
    p.add_argument("--power-plot", help="write the power trace PNG here "
                   "(calculate-power-usage.py plot analogue)")
    p.add_argument("--data-parallel", action="store_true",
                   help="shard engine batches over the ranks of the process "
                   "group (torchrun; one rank without a launcher)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)

    import numpy as np

    from rtdm_tpu_torch.data.camera import FrameSource, is_live_source
    from rtdm_tpu_torch.models.ernet import CLASS_NAMES
    from rtdm_tpu_torch.utils.profiler import (FpsMeter, PowerMonitor,
                                              StepTimer)

    # dispatch() enqueues a batch without waiting for it, so batch k+1 is
    # in flight while batch k is copied back (real-time-inference.py's hot
    # loop, :179-208, is strictly serial)
    mesh = None
    if args.data_parallel:
        from rtdm_tpu_torch.core.mesh import (data_parallel_mesh,
                                              require_data_divisible)
        mesh = data_parallel_mesh(args.device)
        if not args.engine:
            try:
                require_data_divisible(args.batch, mesh, "--batch")
            except ValueError as e:
                raise SystemExit(str(e))
    if args.engine:
        from rtdm_tpu_torch.export.engine import Engine
        engine = Engine.load(args.engine, device=args.device, mesh=mesh)
    else:
        if not args.weights:
            p.error("--weights is required unless --engine is given")
        from rtdm_tpu_torch.export.engine import build_engine
        from rtdm_tpu_torch.models.io import load_variables
        engine = build_engine(args.model, load_variables(args.weights),
                              quant={"int8": "bf16"}.get(args.quant,
                                                         args.quant),
                              batch_size=args.batch, verify=False,
                              device=args.device, mesh=mesh)
    size = engine.spec.image_size

    def resize_frame(frame):
        import cv2
        return cv2.resize(frame, (size, size),
                          interpolation=cv2.INTER_LINEAR)

    src = FrameSource.open(
        int(args.source) if args.source.isdigit() else args.source,
        loop=args.video_looping, width=args.width,
        height=args.height).start()
    bounded = args.max_frames > 0 or not (is_live_source(args.source)
                                          or args.video_looping)
    fps = FpsMeter()
    timer = StepTimer()
    power = PowerMonitor(device=args.device) if args.power else None
    if power:
        power.start()
    if args.save_dir:
        os.makedirs(args.save_dir, exist_ok=True)

    inst_fps = collections.deque(maxlen=100_000)  # bounded on live streams
    predictions = []
    batch_frames, batch_raw = [], []
    n_out = 0
    in_flight = []  # [(device probs, raw frames, submit time)] depth <= 2
    last_drain = [time.perf_counter()]

    def drain_one():
        nonlocal n_out
        dev, raws, t_submit = in_flight.pop(0)
        timer.start()
        probs = dev[: len(raws)].cpu().numpy()  # waits for the card
        timer.stop()
        if power:
            # device-busy estimate: dispatch->ready latency, capped at the
            # wall time since the previous drain (batches overlap)
            now = time.perf_counter()
            power.record_busy(min(now - t_submit, now - last_drain[0]))
            last_drain[0] = now
        # one tick per drained batch (FpsMeter.tick(n)): ticking per frame
        # inside this host loop measures microsecond gaps for --batch > 1
        cur = fps.tick(len(raws))
        inst_fps.append(cur)
        for i, raw in enumerate(raws):
            idx = int(np.argmax(probs[i]))
            conf = float(probs[i][idx])
            if bounded:
                predictions.append((idx, conf))
            label = f"{CLASS_NAMES[idx]} {conf:.2f} | {cur:.1f} FPS"
            if args.save_dir:
                _annotate_and_save(raw, label,
                                   os.path.join(args.save_dir,
                                                f"frame_{n_out:05d}.jpg"))
            if n_out % 25 == 0:
                print(f"frame {n_out}: {label}")
            n_out += 1

    def submit():
        if not batch_frames:
            return
        in_flight.append((engine.dispatch(np.stack(batch_frames)),
                          list(batch_raw), time.perf_counter()))
        batch_frames.clear()
        batch_raw.clear()
        if len(in_flight) > 1:  # keep exactly one batch hidden in flight
            drain_one()

    try:
        for frame in src:
            if args.max_frames:
                # count pending + in-flight + done so exactly max_frames
                # are ingested
                ingested = (n_out + sum(len(f[1]) for f in in_flight)
                            + len(batch_frames))
                if ingested >= args.max_frames:
                    break
            batch_frames.append(resize_frame(frame))
            batch_raw.append(frame)
            if len(batch_frames) >= args.batch:
                submit()
        submit()
        while in_flight:
            drain_one()
    except KeyboardInterrupt:  # graceful exit (real-time-inference.py:210)
        pass
    finally:
        src.stop()
        if power:
            power.stop()

    report = {"frames": n_out, "device": args.device}
    if inst_fps:
        seq = list(inst_fps)
        arr = np.array(seq[1:] if len(seq) > 1 else seq)
        report.update(fps_avg=float(arr.mean()), fps_min=float(arr.min()),
                      fps_max=float(arr.max()),
                      ms_per_batch=timer.mean * 1e3)
        print(f"frames {n_out}  FPS avg {arr.mean():.1f} "
              f"min {arr.min():.1f} max {arr.max():.1f}  "
              f"infer {timer.mean * 1e3:.2f} ms/batch")
        if power:
            report.update(chip_watts=power.chip_watts,
                          mj_per_frame=power.energy_per_frame(n_out),
                          total_j=power.get_total_energy())
            print(f"energy/frame (modelled): "
                  f"{power.energy_per_frame(n_out):.3f} mJ, "
                  f"total {power.get_total_energy():.1f} J")
            if args.power_plot:
                print(f"power trace: {power.plot(args.power_plot)}")
    if bounded:
        report["predictions"] = predictions
    return report


def _annotate_and_save(frame, label: str, path: str) -> None:
    from PIL import Image, ImageDraw
    im = Image.fromarray(frame)
    d = ImageDraw.Draw(im)
    d.rectangle([0, 0, 8 + 7 * len(label), 18], fill=(0, 0, 0))
    d.text((4, 3), label, fill=(0, 255, 128))
    im.save(path)


if __name__ == "__main__":
    main()
