"""Image container and loaders.

A copy of ``surikatoko_tpu/vision/picture.py``, which needs no JAX but
cannot be imported without it (``surikatoko_tpu/__init__.py`` imports jax).
Equivalent of reference image-proc.h ``Picture`` (gray + optional BGR debug
image). Loads PGM/PPM natively (numpy) and anything else through OpenCV if
it is installed. The native frame loader (io/frame_loader.py) decodes the
same formats byte for byte.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass
class Picture:
    gray: np.ndarray                 # [H,W] uint8
    bgr_debug: Optional[np.ndarray] = None

    @property
    def size(self) -> tuple[int, int]:
        return self.gray.shape[1], self.gray.shape[0]


def _read_pnm(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()
    m = re.match(rb"(P[256])\s+(?:#.*\s+)?(\d+)\s+(\d+)\s+(\d+)\s", data)
    if not m:
        raise ValueError(f"not a PNM file: {path}")
    magic, w, h, maxval = m.group(1), int(m.group(2)), int(m.group(3)), int(m.group(4))
    off = m.end()
    if magic == b"P5":
        img = np.frombuffer(data, np.uint8, count=w * h, offset=off).reshape(h, w)
        return img
    if magic == b"P6":
        img = np.frombuffer(data, np.uint8, count=3 * w * h, offset=off).reshape(h, w, 3)
        return img
    if magic == b"P2":
        vals = np.asarray(data[off:].split(), int)[: w * h].reshape(h, w)
        return (vals * 255 // maxval).astype(np.uint8)
    raise ValueError(f"unsupported PNM magic {magic!r}")


def load_picture(path: str) -> Picture:
    ext = os.path.splitext(path)[1].lower()
    is_pnm = ext in (".pgm", ".ppm", ".pnm")
    if is_pnm:
        img = _read_pnm(path)
    else:
        try:
            import cv2  # noqa: F401
            img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
            if img is None:
                raise ValueError(f"cv2 failed to read {path}")
        except ImportError:
            raise ValueError(
                f"can't load {path}: only PGM/PPM supported without OpenCV")
    if img.ndim == 3:
        # PNM P6 is RGB by spec; cv2 decodes BGR. Normalize to BGR for the
        # debug image and use BT.601 integer luma (byte-identical to the
        # native loader, native/frameloader.cpp DecodePnmGray).
        bgr = img[..., ::-1] if is_pnm else img[..., :3]
        b32 = bgr.astype(np.uint32)
        gray = ((114 * b32[..., 0] + 587 * b32[..., 1] + 299 * b32[..., 2])
                // 1000).astype(np.uint8)
        return Picture(gray=gray, bgr_debug=bgr)
    return Picture(gray=img.astype(np.uint8))


def save_picture(path: str, img: np.ndarray) -> None:
    """Write a PGM (P5, [H,W]) or PPM (P6, [H,W,3] RGB) binary image —
    the encoder side of :func:`_read_pnm` / the native loader's decoder
    (round trip pinned in tests/test_torch_vision_io.py). ``chip_smoke.py``'s
    image-sequence phase writes its frames through this, so the measured
    host loop runs the encode -> decode -> prefetch -> device seam."""
    a = np.ascontiguousarray(np.clip(np.asarray(img), 0, 255), np.uint8)
    if a.ndim == 2:
        magic, (h, w) = b"P5", a.shape
    elif a.ndim == 3 and a.shape[2] == 3:
        magic, (h, w) = b"P6", a.shape[:2]
    else:
        raise ValueError(f"expected [H,W] or [H,W,3], got {a.shape}")
    with open(path, "wb") as f:
        f.write(magic + b"\n" + f"{w} {h}\n255\n".encode())
        f.write(a.tobytes())


def list_image_dir(dir_path: str) -> list[str]:
    exts = (".pgm", ".ppm", ".png", ".jpg", ".jpeg", ".bmp")
    names = sorted(n for n in os.listdir(dir_path)
                   if n.lower().endswith(exts))
    return [os.path.join(dir_path, n) for n in names]
