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


def library_path(source: Path, flags: list[str]) -> Path:
    """``_build/lib<stem>_<hash>.so``, keyed by the source and the flags."""
    tag = hashlib.sha256(source.read_bytes() + " ".join(flags).encode()
                         ).hexdigest()[:16]
    return BUILD_DIR / f"lib{source.stem}_{tag}.so"


def build_library(source: Path, cmd: list[str]) -> tuple[Path, str | None]:
    """Compile ``source`` with ``cmd`` (the compiler and its flags; ``-o``
    and the source are appended) into :func:`library_path` unless it is
    there. Returns (path, the compiler's output, or None if it was built
    already). The library appears whole or not at all: it is written to a
    temporary name and renamed."""
    out = library_path(source, cmd[1:])
    if out.exists():
        return out, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        done = subprocess.run([*cmd, "-o", tmp, str(source)], check=True,
                              capture_output=True, text=True)
        os.replace(tmp, out)
    except subprocess.CalledProcessError as e:
        raise RuntimeError(f"{cmd[0]} failed on {source}:\n{e.stderr}") from e
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out, done.stdout + done.stderr


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
        return library_path(self.source, NVCC_FLAGS)

    def build(self) -> Path:
        """Compile the library if it is not built yet; returns its path."""
        if self.path().exists():
            return self.path()
        nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
        if not os.path.exists(nvcc):
            raise RuntimeError(f"nvcc not found: {self.source.name} cannot be built")
        out, report = build_library(self.source, [nvcc, *NVCC_FLAGS])
        if report is not None:
            self.ptxas = report
        return out

    def fn(self):
        """The exported C function, built and loaded on first use."""
        if self._fn is None:
            fn = getattr(ctypes.CDLL(str(self.build())), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn
