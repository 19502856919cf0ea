"""Delimited-text matrix IO (reference mat-serialization.{h,cpp}: the format
of the Oxford dino P-matrices and viff.xy track files).

A copy of ``surikatoko_tpu/io/mat_io.py``, which uses no jax itself: the
port cannot import it, because importing any ``surikatoko_tpu`` module
imports jax.
"""

from __future__ import annotations

import os

import numpy as np


def read_matrix_from_file(path: str | os.PathLike, delim: str | None = None
                          ) -> np.ndarray:
    """Read a whitespace- or tab-delimited numeric matrix. Raises on ragged rows."""
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            parts = line.split(delim) if delim and delim != " " else line.split()
            rows.append([float(p) for p in parts])
    if not rows:
        raise ValueError(f"empty matrix file: {path}")
    width = len(rows[0])
    for i, r in enumerate(rows):
        if len(r) != width:
            raise ValueError(f"ragged row {i} in {path}: {len(r)} != {width}")
    return np.asarray(rows)


def write_matrix_to_file(path: str | os.PathLike, mat: np.ndarray,
                         delim: str = "\t") -> None:
    with open(path, "w") as f:
        for row in np.asarray(mat):
            f.write(delim.join(repr(float(v)) for v in row) + "\n")
