"""Unified frame sources with a threaded grab loop.

Counterpart of ``rtdm_tpu/data/camera.py`` (a copy: host code, no device
work; cv2 is imported only where a video, webcam or GStreamer source is
read). Re-implements the reference's capture layer semantics
(tensorrt_inference/utils/camera.py:140+ — IP/RTSP/USB/onboard/video/image
unified behind one class with a background grab thread;
real-time-inference.py:167-171 — imutils WebcamVideoStream/FileVideoStream):

- `FrameSource.open(uri)` accepts: an image file, a directory of images, a
  video file, an integer/'/dev/videoN' webcam id, or an rtsp:// URL.
- A daemon thread grabs frames into a 1-slot latest-frame mailbox (live
  sources drop stale frames, exactly like the threaded grab in the
  reference) or a bounded queue (file sources, lossless).
- Frames come out as RGB uint8 HWC.
"""

from __future__ import annotations

import glob
import os
import queue
import threading
import time
from typing import Iterator, Optional

import numpy as np

IMG_EXTS = (".jpg", ".jpeg", ".png", ".bmp")
VID_EXTS = (".mp4", ".avi", ".mov", ".mkv", ".m4v")


def _resize_frame(frame: np.ndarray, wh) -> np.ndarray:
    """Host-side resize to (w, h) — the --do_resize path. cv2 INTER_LINEAR
    (what the reference's cv2.resize default does), PIL fallback."""
    w, h = wh
    if frame.shape[1] == w and frame.shape[0] == h:
        return frame
    try:
        import cv2
        return cv2.resize(frame, (w, h), interpolation=cv2.INTER_LINEAR)
    except ImportError:
        from PIL import Image
        return np.asarray(Image.fromarray(frame).resize((w, h),
                                                        Image.BILINEAR))


class FrameSource:
    def __init__(self, uri, live: bool, queue_size: int = 64):
        self.uri = uri
        self.live = live
        self._queue: "queue.Queue" = queue.Queue(maxsize=1 if live
                                                 else queue_size)
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.error: Optional[BaseException] = None  # producer failure
        self.frames_read = 0
        self.loop = False      # --video_looping analogue (camera.py:31-32)
        self.resize = None     # (w, h) --do_resize/--width/--height analogue

    # -- construction ---------------------------------------------------
    @staticmethod
    def open(uri, loop: bool = False, width: int = 0,
             height: int = 0) -> "FrameSource":
        """`loop` replays finite sources forever (the reference's
        --video_looping, camera.py:31-32 / grab_img loop); `width`/`height`
        (both > 0) resize every frame on the host before it enters the
        mailbox (--do_resize --width --height, camera.py:46-51)."""
        if (isinstance(uri, str) and is_gst_pipeline(uri)
                and ("{width}" in uri or "{height}" in uri)):
            # open_cam_gstr (camera.py:88-96): width/height format into
            # the pipeline string, not a host-side resize
            uri = uri.format(width=width or 1280, height=height or 720)
            width = height = 0
        src = FrameSource._open(uri, loop=loop)
        src.loop = bool(loop)
        if width > 0 and height > 0:
            src.resize = (int(width), int(height))
        return src

    @staticmethod
    def _open(uri, loop: bool = False) -> "FrameSource":
        if isinstance(uri, (list, tuple)):
            return _MultiSource([FrameSource.open(u, loop=loop)
                                 for u in uri])
        if uri == "onboard":
            # the reference's --onboard flag (utils/camera.py:42-43,197)
            return _GstSource(gst_onboard_pipeline())
        if isinstance(uri, str) and is_gst_pipeline(uri):
            # raw GStreamer pipeline string (open_cam_gstr / the rtsp, usb
            # and Jetson-onboard modes of tensorrt_inference/utils/
            # camera.py:45-125; builders below construct the same strings)
            return _GstSource(uri.removeprefix("gst://"))
        if isinstance(uri, int) or (isinstance(uri, str)
                                    and uri.startswith("/dev/video")):
            return _CvSource(uri, live=True)
        if isinstance(uri, str) and uri.startswith(("rtsp://", "http://",
                                                    "https://")):
            return _CvSource(uri, live=True)
        if os.path.isdir(uri):
            return _ImageDirSource(uri)
        if isinstance(uri, str) and uri.lower().endswith(IMG_EXTS):
            return _ImageDirSource(uri, single=True)
        if isinstance(uri, str) and uri.lower().endswith(VID_EXTS):
            return _CvSource(uri, live=False)
        if isinstance(uri, str) and uri.lower().endswith(".streams"):
            # a text file listing one source URI per line — the reference's
            # multi-camera convention (yolov5/utils/datasets.py LoadStreams,
            # detect.py '--source streams.txt')
            with open(uri) as f:
                lines = [ln.strip() for ln in f]
            # numeric lines are webcam ids, the reference's streams.txt
            # convention (yolov5/utils/datasets.py:188-193)
            uris = [int(ln) if ln.isdigit() else ln
                    for ln in lines if ln and not ln.startswith("#")]
            if not uris:
                raise ValueError(f"no sources listed in {uri}")
            return _MultiSource([FrameSource.open(u, loop=loop)
                                 for u in uris])
        raise ValueError(f"unrecognized source: {uri!r}")

    # -- threaded producer ----------------------------------------------
    def start(self) -> "FrameSource":
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def _run(self) -> None:
        # try/finally: a producer exception must still deliver the
        # end-of-stream sentinel (else consumers block the full read
        # timeout and mistake the failure for a clean end); the error is
        # kept for read() to re-raise.
        try:
            while True:
                for frame in self._produce():
                    if self._stop.is_set():
                        return
                    if self.resize is not None:
                        frame = _resize_frame(frame, self.resize)
                    if self.live:
                        # latest-frame mailbox: drop stale
                        try:
                            self._queue.get_nowait()
                        except queue.Empty:
                            pass
                    self._queue.put(frame)
                # finite source exhausted: replay if looping
                # (--video_looping), else signal end-of-stream
                if not self.loop or self.live or self._stop.is_set():
                    break
        except BaseException as e:  # noqa: BLE001 — stored, re-raised in read()
            self.error = e
        finally:
            self._put_sentinel()

    def _put_sentinel(self) -> None:
        """Enqueue the end sentinel WITHOUT losing frames: a full queue
        usually means the consumer is merely lagging (it will drain), so
        block politely first; only a consumer that stays gone past the
        grace period (or one that called stop()) forfeits frames — then
        stale ones are dropped so the daemon thread (and its open capture)
        can exit instead of wedging forever."""
        grace_s = 0.0 if self._stop.is_set() else 60.0
        deadline = time.monotonic() + grace_s
        while True:
            try:
                self._queue.put(None, timeout=0.25)
                return
            except queue.Full:
                if self._stop.is_set() or time.monotonic() >= deadline:
                    break
        while True:
            try:
                self._queue.put_nowait(None)
                return
            except queue.Full:
                try:
                    self._queue.get_nowait()
                except queue.Empty:
                    pass

    def _produce(self) -> Iterator[np.ndarray]:
        raise NotImplementedError

    # -- consumer --------------------------------------------------------
    def read(self, timeout: float = 10.0) -> Optional[np.ndarray]:
        try:
            frame = self._queue.get(timeout=timeout)
        except queue.Empty:
            return None
        if frame is None and self.error is not None:
            raise RuntimeError(
                f"frame source {self.uri!r} failed") from self.error
        if frame is not None:
            self.frames_read += 1
        return frame

    def __iter__(self) -> Iterator[np.ndarray]:
        while True:
            frame = self.read()
            if frame is None:
                return
            yield frame

    def stop(self) -> None:
        self._stop.set()


class _ImageDirSource(FrameSource):
    def __init__(self, path: str, single: bool = False):
        super().__init__(path, live=False)
        if single:
            self.paths = [path]
        else:
            self.paths = sorted(
                p for p in glob.glob(os.path.join(path, "*"))
                if p.lower().endswith(IMG_EXTS))
        if not self.paths:
            raise FileNotFoundError(f"no images under {path}")

    def _produce(self):
        from PIL import Image
        for p in self.paths:
            with open(p, "rb") as f:
                yield np.asarray(Image.open(f).convert("RGB"), np.uint8)


class _MultiSource(FrameSource):
    """N simultaneous sources behind the single-source interface — the
    LoadStreams analogue (yolov5/utils/datasets.py:185+). Each child keeps
    its own grab thread + mailbox; frames come out round-robin (source k,
    k+1, ...), so downstream batching interleaves all cameras instead of
    stacking one synchronized frame per source (fixed-shape consumers
    letterbox per frame anyway, so synchronized stacking buys nothing). A
    child that ends or stalls past `child_timeout` is dropped;
    the multi-source ends when every child has."""

    def __init__(self, children, child_timeout: float = 5.0):
        live = any(c.live for c in children)
        super().__init__([c.uri for c in children], live=live)
        # staleness-dropping happens per-child (their live mailboxes); the
        # aggregate queue must hold one frame per camera or cameras starve
        self._queue = queue.Queue(maxsize=max(2 * len(children), 2))
        self.live = False  # aggregate queue is lossless over children
        self._any_live = live
        self.children = list(children)
        self.child_timeout = child_timeout

    def start(self) -> "FrameSource":
        for c in self.children:
            c.start()
        return super().start()

    def _produce(self):
        import sys
        import time as _time
        alive = list(self.children)
        last_ok = {id(c): _time.monotonic() for c in alive}
        # Poll each child briefly instead of blocking child_timeout on it:
        # one wedged camera must not cap every HEALTHY camera at one frame
        # per (n_stalled * child_timeout). child_timeout is a per-child
        # staleness deadline, not a per-read block.
        poll = min(0.1, self.child_timeout)
        while alive:
            for c in list(alive):
                try:
                    frame = c.read(timeout=poll)
                except RuntimeError as e:
                    # a failed camera is logged and dropped; the others
                    # keep streaming (LoadStreams keeps going when one
                    # cam hiccups)
                    print(f"dropping failed source {c.uri!r}: {e}",
                          file=sys.stderr)
                    alive.remove(c)
                    c.stop()
                    continue
                if frame is None:
                    # distinguish ENDED (producer thread exited AND its
                    # queue fully drained — drop) from a transient stall.
                    # The drained check matters: a read() timeout under
                    # host load also returns None, and the thread may have
                    # exited with frames still queued — dropping then
                    # would lose them.
                    if c._thread is not None:
                        c._thread.join(0.05)  # close the tiny window
                        #   between the end-sentinel put and thread exit
                    if ((c._thread is None or not c._thread.is_alive())
                            and c._queue.empty()):
                        alive.remove(c)
                        c.stop()
                    elif (c.live and _time.monotonic() - last_ok[id(c)]
                            > self.child_timeout):
                        # live feed stalled (producer alive, no frames for
                        # child_timeout): drop it as promised above; file/
                        # dir sources are never staleness-dropped — a slow
                        # decode must not lose frames
                        print(f"dropping stalled source {c.uri!r} (no "
                              f"frame for {self.child_timeout:.1f}s)",
                              file=sys.stderr)
                        alive.remove(c)
                        c.stop()
                    continue
                last_ok[id(c)] = _time.monotonic()
                yield frame

    def stop(self) -> None:
        for c in self.children:
            c.stop()
        super().stop()


def is_live_source(source: str) -> bool:
    """A webcam id, a network stream or a .streams list: a source that may
    never end, whose loop must keep no per-frame state."""
    return source.isdigit() or source.startswith(
        ("rtsp://", "http://", "https://")) or source.endswith(".streams")


def is_gst_pipeline(uri: str) -> bool:
    """A raw GStreamer pipeline: explicit gst:// prefix, or an
    element-chain string (' ! ' separators ending in an appsink — the
    shape every reference pipeline has, utils/camera.py:60-125)."""
    return uri.startswith("gst://") or (" ! " in uri and "appsink" in uri)


def gst_rtsp_pipeline(uri: str, width: int = 1280, height: int = 720,
                      latency: int = 200, elements: Optional[str] = None
                      ) -> str:
    """RTSP-over-GStreamer pipeline string (open_cam_rtsp,
    utils/camera.py:45-76): hardware omxh264dec when present, else
    software avdec_h264. `elements` is the gst-inspect-1.0 output
    (injectable for tests; probed when None)."""
    elements = _gst_elements() if elements is None else elements
    if "omxh264dec" in elements:
        return ("rtspsrc location={} latency={} ! "
                "rtph264depay ! h264parse ! omxh264dec ! "
                "nvvidconv ! "
                "video/x-raw, width=(int){}, height=(int){}, "
                "format=(string)BGRx ! videoconvert ! "
                "appsink").format(uri, latency, width, height)
    if "avdec_h264" in elements:
        return ("rtspsrc location={} latency={} ! "
                "rtph264depay ! h264parse ! avdec_h264 ! "
                "videoconvert ! appsink").format(uri, latency)
    raise RuntimeError("H.264 decoder not found!")


def gst_usb_pipeline(dev: int, width: int = 1280, height: int = 720) -> str:
    """USB webcam via v4l2src (open_cam_usb, utils/camera.py:78-86)."""
    return ("v4l2src device=/dev/video{} ! "
            "video/x-raw, width=(int){}, height=(int){} ! "
            "videoconvert ! appsink").format(dev, width, height)


def gst_onboard_pipeline(width: int = 1280, height: int = 720,
                         elements: Optional[str] = None) -> str:
    """Jetson onboard camera (open_cam_onboard, utils/camera.py:99-125):
    nvcamerasrc (pre-L4T-28.1) or nvarguscamerasrc."""
    elements = _gst_elements() if elements is None else elements
    if "nvcamerasrc" in elements:
        return ("nvcamerasrc ! "
                "video/x-raw(memory:NVMM), "
                "width=(int)2592, height=(int)1458, "
                "format=(string)I420, framerate=(fraction)30/1 ! "
                "nvvidconv ! "
                "video/x-raw, width=(int){}, height=(int){}, "
                "format=(string)BGRx ! "
                "videoconvert ! appsink").format(width, height)
    if "nvarguscamerasrc" in elements:
        return ("nvarguscamerasrc ! "
                "video/x-raw(memory:NVMM), "
                "width=(int)1920, height=(int)1080, "
                "format=(string)NV12, framerate=(fraction)30/1 ! "
                "nvvidconv flip-method=2 ! "
                "video/x-raw, width=(int){}, height=(int){}, "
                "format=(string)BGRx ! "
                "videoconvert ! appsink").format(width, height)
    raise RuntimeError("onboard camera source not found!")


def _gst_elements() -> str:
    """gst-inspect-1.0 element listing ('' when GStreamer is absent)."""
    import subprocess
    try:
        return str(subprocess.check_output("gst-inspect-1.0",
                                           stderr=subprocess.DEVNULL))
    except Exception:
        return ""


class _GstSource(FrameSource):
    """Raw-pipeline capture: cv2.VideoCapture(pipeline, CAP_GSTREAMER) —
    the cap the reference builds for rtsp/usb/onboard (utils/camera.py).
    Live semantics (latest-frame mailbox): pipelines are cameras/streams."""

    def __init__(self, pipeline: str):
        super().__init__(pipeline, live=True)

    def _produce(self):
        import cv2
        cap = cv2.VideoCapture(self.uri, cv2.CAP_GSTREAMER)
        if not cap.isOpened():
            raise RuntimeError(
                f"cannot open GStreamer pipeline {self.uri!r} (is the "
                "cv2 build GStreamer-enabled and the pipeline valid?)")
        try:
            while True:
                ok, frame_bgr = cap.read()
                if not ok:
                    return
                yield frame_bgr[:, :, ::-1].copy()
        finally:
            cap.release()


class _CvSource(FrameSource):
    def __init__(self, uri, live: bool):
        super().__init__(uri, live=live)

    def _produce(self):
        import cv2
        cap = cv2.VideoCapture(self.uri)
        if not cap.isOpened():
            raise RuntimeError(f"cannot open capture source {self.uri!r}")
        try:
            while True:
                ok, frame_bgr = cap.read()
                if not ok:
                    return
                yield frame_bgr[:, :, ::-1].copy()  # BGR -> RGB
        finally:
            cap.release()
