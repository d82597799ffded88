"""Build and bind the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` exports a plain C launch function. At first use it
is compiled by ``nvcc`` for Hopper (``sm_90a``) under a name that carries a
hash of the source and the flags, and loaded with ``ctypes``. The library
goes to ``build/kernels/`` at the root of the checkout that holds the
package; an installed package (no ``pyproject.toml`` beside it) builds into
``~/.cache/rtdm_tpu_torch/kernels/`` instead. Nothing is compiled or loaded
when this module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import List

CSRC = Path(__file__).resolve().parent.parent / "csrc"
_CHECKOUT = CSRC.parents[1]
BUILD_DIR = (_CHECKOUT / "build" / "kernels"
             if (_CHECKOUT / "pyproject.toml").is_file()
             else Path.home() / ".cache" / "rtdm_tpu_torch" / "kernels")
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
