"""Build and load the package's hand-written CUDA kernels.

Each kernel source under ``csrc/`` is compiled on its own with nvcc into a
shared library with a plain C entry point, in ``_build/`` next to this
package, and loaded through ctypes. The library's name carries a hash of the
source and the flags, so a changed source is rebuilt and a change to one
source leaves the others' libraries alone. Nothing is built at import time:
the first launch (or :meth:`KernelLibrary.build`) does it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


class KernelLibrary:
    """One ``csrc/<name>.cu`` source and the C function it exports, which
    returns a ``cudaError_t`` (0 = launched). ``source`` is a file name
    under ``csrc/`` or an absolute path."""

    def __init__(self, source: str, symbol: str, argtypes: list):
        self.source = _PKG / "csrc" / source
        self.symbol = symbol
        self.argtypes = argtypes
        self._fn = None
        # ptxas's report (registers, spills) of the build this process ran
        self.ptxas = ""

    def path(self) -> Path:
        """Where the library of the current source and flags lives."""
        src = self.source.read_bytes()
        tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        return BUILD_DIR / f"lib{self.source.stem}_{tag}.so"

    def build(self) -> Path:
        """Compile the library if it is not built yet; returns its path."""
        out = self.path()
        if out.exists():
            return out
        nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
        if not os.path.exists(nvcc):
            raise RuntimeError(f"nvcc not found: {self.source.name} cannot be built")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            done = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp, str(self.source)],
                                  check=True, capture_output=True, text=True)
            os.replace(tmp, out)
            self.ptxas = done.stdout + done.stderr
        except subprocess.CalledProcessError as e:
            raise RuntimeError(f"nvcc failed on {self.source}:\n{e.stderr}") from e
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        return out

    def fn(self):
        """The exported C function, built and loaded on first use."""
        if self._fn is None:
            fn = getattr(ctypes.CDLL(str(self.build())), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn
