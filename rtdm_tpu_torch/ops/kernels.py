"""Build and bind the hand-written CUDA kernels and the host library under
``csrc/``.

Each ``csrc/<name>.cu`` exports a plain C launch function. At first use it
is compiled by ``nvcc`` for Hopper (``sm_90a``) under a name that carries a
hash of the source and the flags, and loaded with ``ctypes``. The library
goes to ``build/kernels/`` at the root of the checkout that holds the
package; an installed package (no ``pyproject.toml`` beside it) builds into
``~/.cache/rtdm_tpu_torch/kernels/`` instead.

``csrc/rtdm_io.cpp``, the host IO library (``data/native_io.py``), is
built the same way by ``g++`` into ``build/native/`` (or
``~/.cache/rtdm_tpu_torch/native/``), linked against the system's libjpeg
where its headers are installed, else against the libjpeg-turbo that
Pillow's wheel bundles, by its full path, compiled with the libjpeg 6.2
headers in ``csrc/jpeg/``. Nothing is compiled or loaded when this module
is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
_CHECKOUT = CSRC.parents[1]
BUILD_DIR = (_CHECKOUT / "build" / "kernels"
             if (_CHECKOUT / "pyproject.toml").is_file()
             else Path.home() / ".cache" / "rtdm_tpu_torch" / "kernels")
NATIVE_DIR = BUILD_DIR.parent / "native"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       f"{CSRC} with the CUDA toolkit")


def nvcc_command(src: Path, lib: Path) -> List[str]:
    """The ``nvcc`` command that compiles ``src`` into the shared library
    ``lib`` with the port's flags."""
    return [_nvcc(), *NVCC_FLAGS, "-o", str(lib), str(src)]


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless it is built already. Returns the
    compiler log (registers, shared memory and spills from ``-Xptxas -v``);
    raises if the compile fails."""
    lib = library_path(name)
    if not lib.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(".tmp")       # no half-written library on a kill
        proc = subprocess.run(
            nvcc_command(CSRC / f"{name}.cu", tmp),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        lib.with_suffix(".log").write_text(proc.stdout)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{proc.stdout}")
        os.replace(tmp, lib)
    return lib.with_suffix(".log").read_text()


GXX_FLAGS = ("-O3", "-fPIC", "-Wall", "-std=c++17", "-shared")
_SYSTEM_INCLUDE = (Path("/usr/include"), Path("/usr/local/include"))
_host_lock = threading.Lock()


def libjpeg_flags() -> Tuple[List[str], List[str]]:
    """(compile flags, link flags) for libjpeg: ``-ljpeg`` where the system
    has its development files, else the libjpeg-turbo of Pillow's wheel by
    its full path (with an rpath to it) and the headers in ``csrc/jpeg/``.
    ``jpeg_CreateDecompress`` checks the library's version and struct size
    against the headers', so a mismatched library fails every decode
    rather than decoding wrong."""
    if any((d / "jpeglib.h").is_file() for d in _SYSTEM_INCLUDE):
        return [], ["-ljpeg"]
    import PIL
    libs = sorted((Path(PIL.__file__).resolve().parent.parent
                   / "pillow.libs").glob("libjpeg-*.so*"))
    if not libs:
        raise RuntimeError("no libjpeg: neither its development files "
                           "(jpeglib.h) nor the libjpeg-turbo of Pillow's "
                           "wheel (pillow.libs/libjpeg-*.so*) is installed")
    headers = CSRC / "jpeg"
    return ([f"-I{headers}", f"-I{headers / 'x86_64-linux-gnu'}"],
            [str(libs[0]), f"-Wl,-rpath,{libs[0].parent}"])


def gxx_command(src: Path, lib: Path) -> List[str]:
    """The ``g++`` command that compiles the host source ``src`` into the
    shared library ``lib``, linked against libjpeg and pthreads."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError(f"g++ not found: the host library is built from "
                           f"{src} with a C++17 compiler")
    cflags, ldflags = libjpeg_flags()
    return [cxx, *GXX_FLAGS, *cflags, str(src), "-o", str(lib), *ldflags,
            "-lpthread"]


def host_library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cpp").read_bytes()
    cflags, ldflags = libjpeg_flags()
    flags = " ".join((*GXX_FLAGS, *cflags, *ldflags))
    digest = hashlib.sha256(src + flags.encode()).hexdigest()
    return NATIVE_DIR / f"lib{name}-{digest[:12]}.so"


def linked_libjpeg(lib: Path) -> Tuple[str, str]:
    """(path, version) of the libjpeg that the built ``lib`` loads, as the
    dynamic loader resolves it (``ldd``); the version is the
    libjpeg-turbo string inside that file, or "unknown"."""
    out = subprocess.run(["ldd", str(lib)], capture_output=True, text=True,
                         check=True).stdout
    found = re.search(r"libjpeg\S*\s+=>\s+(\S+)", out)
    if found is None:
        raise RuntimeError(f"{lib} links no libjpeg:\n{out}")
    path = os.path.realpath(found.group(1))
    with open(path, "rb") as f:
        version = re.search(rb"libjpeg-turbo version ([0-9.]+)", f.read())
    return path, version.group(1).decode() if version else "unknown"


def build_host(name: str) -> Path:
    """Compile ``csrc/<name>.cpp`` unless it is built already, and return
    the library's path. Its ``.log`` holds the command, the libjpeg it
    linked with that library's version, and the compiler's output; raises
    if the compile fails. Serialised within a process (loader threads reach
    the first decode together); processes that race each write their own
    temporary file and ``os.replace`` it, so none loads a partial one."""
    lib = host_library_path(name)
    with _host_lock:
        if lib.exists():
            return lib
        NATIVE_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = gxx_command(CSRC / f"{name}.cpp", tmp)
        proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"g++ failed for {name}:\n{proc.stdout}")
        jpeg, version = linked_libjpeg(tmp)
        log = tmp.with_suffix(".log")
        shown = " ".join(cmd).replace(str(tmp), str(lib))
        log.write_text(f"command: {shown}\n"
                       f"libjpeg: {jpeg} (libjpeg-turbo {version})\n"
                       f"{proc.stdout}")
        os.replace(log, lib.with_suffix(".log"))
        os.replace(tmp, lib)
    return lib


class CudaKernel:
    """One C launch function of a ``csrc/`` source, with its launch count.

    ``launches`` goes up by one for every launch that the CUDA runtime
    accepted, and nowhere else."""

    def __init__(self, source: str, symbol: str, argtypes: List[type]):
        self.source = source
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self._fn = None
        self._lib = None

    def _bind(self):
        if self._fn is None:
            build(self.source)
            self._lib = ctypes.CDLL(str(library_path(self.source)))
            fn = getattr(self._lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            err = getattr(self._lib, f"{self.source}_error_string")
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            self._fn = fn
        return self._fn

    def launch(self, *args) -> None:
        rc = self._bind()(*args)
        if rc != 0:
            msg = getattr(self._lib, f"{self.source}_error_string")(rc)
            raise RuntimeError(f"{self.symbol} launch failed: CUDA error "
                               f"{rc} ({msg.decode()})")
        self.launches += 1
