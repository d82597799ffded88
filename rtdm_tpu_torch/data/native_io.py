"""ctypes bridge to the host IO library, ``csrc/rtdm_io.cpp``.

Counterpart of ``rtdm_tpu/data/native_io.py``, with a copy of its C++
source: a libjpeg decode with DCT prescaling (decode at the smallest n/8
of the full size that covers the target), a fixed-point bilinear resize
with cv2's half-pixel convention, the gray letterbox, and a batch decode
of files on a pool of native threads. ``ops/kernels.py::build_host``
builds it with g++ at first use into ``build/native/``, under a name that
carries a hash of the source and the flags, so a stale library is never
loaded. When it cannot be built or loaded, ``available()`` is False, the
reason is logged, and every caller takes its PIL path, as the JAX package
does on a machine without libjpeg.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)

_lib = None
_tried = False
_load_lock = threading.Lock()


def _load():
    global _lib, _tried
    if _tried:
        return _lib
    # the loader's threads reach the first decode together: one builds and
    # binds, the others wait on the lock for its result (the attempt is
    # marked done only once it has ended, so none falls back to PIL
    # while the build runs)
    with _load_lock:
        if not _tried:
            _lib = _bind()
            _tried = True
    return _lib


def _bind():
    from rtdm_tpu_torch.ops import kernels
    try:
        lib = ctypes.CDLL(str(kernels.build_host("rtdm_io")))
    except (OSError, RuntimeError, subprocess.SubprocessError) as e:
        logger.warning("native IO unavailable (%s); using the PIL path", e)
        return None
    u8p = ctypes.POINTER(ctypes.c_uint8)
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int)
    lib.rtdm_decode_jpeg_letterbox_rect.argtypes = [
        u8p, ctypes.c_long, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_uint8, u8p, f32p, f32p, f32p, i32p, i32p]
    lib.rtdm_decode_jpeg_letterbox_rect.restype = ctypes.c_int
    lib.rtdm_letterbox_rgb.argtypes = [
        u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_uint8, u8p,
        f32p, f32p, f32p]
    lib.rtdm_letterbox_rgb.restype = ctypes.c_int
    lib.rtdm_decode_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_uint8, u8p, f32p, f32p, i32p, i32p,
        ctypes.c_int]
    lib.rtdm_decode_batch.restype = ctypes.c_int
    return lib


def available() -> bool:
    return _load() is not None


def _u8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def decode_jpeg_letterbox(data: bytes, size: int, pad_value: int = 114
                          ) -> Optional[Tuple[np.ndarray, float,
                                              Tuple[float, float],
                                              Tuple[int, int]]]:
    """JPEG bytes -> (letterboxed (size, size, 3) uint8, gain, (pad_w,
    pad_h), (orig_h, orig_w)); None when native IO or the decode is
    unavailable. The square decode is the uncapped rect decode with
    th == tw, as on the C side."""
    return decode_jpeg_letterbox_rect(data, size, size, pad_value,
                                      gain_cap=0.0)


def decode_jpeg_letterbox_rect(data: bytes, out_h: int, out_w: int,
                               pad_value: int = 114,
                               gain_cap: float = 0.0
                               ) -> Optional[Tuple[np.ndarray, float,
                                                   Tuple[float, float],
                                                   Tuple[int, int]]]:
    """JPEG bytes -> (letterboxed (out_h, out_w, 3) uint8, gain, (pad_w,
    pad_h), (orig_h, orig_w)) for a rect target (the rect-batch bucket
    shapes). ``gain_cap`` > 0 bounds the resize factor, so a bucket larger
    than the image's fit becomes border, not resolution; None when native
    IO or the decode is unavailable (a PNG or a corrupt body)."""
    lib = _load()
    if lib is None:
        return None
    out = np.empty((out_h, out_w, 3), np.uint8)
    gain, pw, ph = ctypes.c_float(), ctypes.c_float(), ctypes.c_float()
    oh, ow = ctypes.c_int(), ctypes.c_int()
    buf = np.frombuffer(data, np.uint8)
    rc = lib.rtdm_decode_jpeg_letterbox_rect(
        _u8(buf), len(data), out_h, out_w, 1, float(gain_cap), pad_value,
        _u8(out), ctypes.byref(gain), ctypes.byref(pw), ctypes.byref(ph),
        ctypes.byref(oh), ctypes.byref(ow))
    if rc != 0:
        return None
    return out, float(gain.value), (float(pw.value), float(ph.value)), \
        (int(oh.value), int(ow.value))


def decode_batch(paths, size: int, letterbox: bool = True,
                 pad_value: int = 114, nthreads: int = 0):
    """Decode and letterbox a batch of JPEG files into one (N, size, size,
    3) uint8 buffer on the library's thread pool, in one call (``nthreads``
    0: the hardware's concurrency). Returns (batch, gains (N,), pads (N, 2),
    orig_hw (N, 2), ok (N,) bool), or None when native IO is unavailable.
    A failed slot is filled with ``pad_value`` and has ok False; callers
    take their PIL path for it."""
    lib = _load()
    if lib is None:
        return None
    n = len(paths)
    out = np.empty((n, size, size, 3), np.uint8)
    gains = np.empty((n,), np.float32)
    pads = np.empty((n, 2), np.float32)
    orig = np.empty((n, 2), np.int32)
    rcs = np.empty((n,), np.int32)
    if n == 0:
        return out, gains, pads, orig, np.zeros((0,), bool)
    arr = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    lib.rtdm_decode_batch(
        arr, n, size, int(letterbox), pad_value, _u8(out),
        gains.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        pads.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        orig.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        rcs.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), nthreads)
    return out, gains, pads, orig, rcs == 0


def letterbox_rgb(frame: np.ndarray, size: int, pad_value: int = 114
                  ) -> Optional[Tuple[np.ndarray, float,
                                      Tuple[float, float]]]:
    """A decoded RGB frame -> (letterboxed (size, size, 3) uint8, gain,
    (pad_w, pad_h)); None when native IO is unavailable."""
    lib = _load()
    if lib is None:
        return None
    frame = np.ascontiguousarray(frame, np.uint8)
    h, w = frame.shape[:2]
    out = np.empty((size, size, 3), np.uint8)
    gain, pw, ph = ctypes.c_float(), ctypes.c_float(), ctypes.c_float()
    lib.rtdm_letterbox_rgb(_u8(frame), h, w, size, pad_value, _u8(out),
                           ctypes.byref(gain), ctypes.byref(pw),
                           ctypes.byref(ph))
    return out, float(gain.value), (float(pw.value), float(ph.value))
