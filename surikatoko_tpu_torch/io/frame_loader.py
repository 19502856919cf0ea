"""The native prefetching frame loader (ctypes), with the pure-Python PGM/PPM
reader as its fallback.

Port of ``surikatoko_tpu/io/frame_loader.py``. The C++ source is the JAX
package's ``native/frameloader.cpp``, left as it is: the port compiles it
with g++ into its own ``_build/`` (keyed by a hash of the source and the
flags, as the CUDA kernels are, ops/cuda_build.py) and never writes under
``native/``. If g++ or the build fails, or the directory holds no decodable
PNM file, it falls back to vision/picture.py (``native`` is then False).
Decoding runs on a C++ worker thread ``prefetch_depth`` frames ahead of the
consumer, in filename order.

Iteration yields (frame index, gray [H,W] uint8 tensor on the host). For a
CUDA ``device`` the frame is in pinned memory, so its copy to the card can
be ``non_blocking`` and overlap the work queued before it; each frame has a
buffer of its own from torch's caching host allocator, which does not hand
a buffer out again while a copy from it is in flight.
"""

from __future__ import annotations

import ctypes
import shutil
from pathlib import Path

import torch

from surikatoko_tpu_torch.ops.cuda_build import build_library
from surikatoko_tpu_torch.vision.picture import list_image_dir, load_picture

SOURCE = Path(__file__).resolve().parents[2] / "native" / "frameloader.cpp"
CXX_FLAGS = ["-O2", "-std=c++17", "-fPIC", "-shared", "-pthread"]
_lib = None
_build_failed = False


def _get_lib():
    """The loaded library, built on first use; None if it cannot be."""
    global _lib, _build_failed
    if _lib is not None or _build_failed:
        return _lib
    cxx = shutil.which("g++")
    try:
        if cxx is None or not SOURCE.exists():
            raise OSError("g++ or native/frameloader.cpp missing")
        path, _ = build_library(SOURCE, [cxx, *CXX_FLAGS])
        lib = ctypes.CDLL(str(path))
    except (OSError, RuntimeError):
        _build_failed = True
        return None
    lib.fl_open.restype = ctypes.c_void_p
    lib.fl_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.fl_frame_count.argtypes = [ctypes.c_void_p]
    lib.fl_width.argtypes = [ctypes.c_void_p]
    lib.fl_height.argtypes = [ctypes.c_void_p]
    lib.fl_next.restype = ctypes.c_int
    lib.fl_next.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
    lib.fl_close.argtypes = [ctypes.c_void_p]
    _lib = lib
    return _lib


class FrameLoader:
    """Iterate grayscale frames from a directory of PGM/PPM images, for
    ``device`` (pinned host buffers for a CUDA device)."""

    def __init__(self, image_dir: str, prefetch_depth: int = 4,
                 device: torch.device | str = "cuda"):
        self.image_dir = str(image_dir)
        self.pin = torch.device(device).type == "cuda"
        self._handle = None
        self._lib = _get_lib()
        self.native = self._lib is not None
        if self.native:
            h = self._lib.fl_open(self.image_dir.encode(), prefetch_depth)
            if not h:
                self.native = False  # no decodable PNM files; fall back
            else:
                self._handle = ctypes.c_void_p(h)
                self.frame_count = self._lib.fl_frame_count(self._handle)
                self.width = self._lib.fl_width(self._handle)
                self.height = self._lib.fl_height(self._handle)
        if not self.native:
            self._paths = list_image_dir(self.image_dir)
            if not self._paths:
                raise FileNotFoundError(f"no images in {self.image_dir}")
            first = load_picture(self._paths[0])
            self.frame_count = len(self._paths)
            self.height, self.width = first.gray.shape

    def __iter__(self):
        if self.native:
            while True:
                gray = torch.empty((self.height, self.width), dtype=torch.uint8,
                                   pin_memory=self.pin)
                idx = self._lib.fl_next(self._handle, gray.data_ptr(),
                                        gray.numel())
                if idx == -1:
                    break
                if idx == -2:
                    raise IOError(f"native decode error in {self.image_dir}")
                yield idx, gray
        else:
            for i, p in enumerate(self._paths):
                gray = torch.tensor(load_picture(p).gray)
                yield i, gray.pin_memory() if self.pin else gray

    def close(self):
        if self.native and self._handle:
            self._lib.fl_close(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
