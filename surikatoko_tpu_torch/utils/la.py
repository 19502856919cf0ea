"""Gauss-Jordan elimination with partial pivoting.

Port of ``surikatoko_tpu/utils/la.py`` (parity with the reference
prototype's ``GaussJordanElimination``, py_proto/suriko/la_utils.py:1-40):
a fixed trip count with the pivot chosen by a masked argmax and the rows
swapped functionally, returning ``(rref, ok)``, so nothing reads the
device until the caller reads ``ok``.
"""

from __future__ import annotations

import torch


def gauss_jordan(m: torch.Tensor, eps: float = 1e-10
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Reduce ``m`` [N, C] to reduced row echelon form.

    Returns (rref, ok): ok is False if a pivot magnitude falls below ``eps``
    (a singular top-left block), the reference's False return
    (la_utils.py:19). On failure the returned matrix is unspecified."""
    a = torch.as_tensor(m).clone()
    nrows, ncols = a.shape
    rows = torch.arange(nrows, device=a.device)
    ok = torch.ones((), dtype=torch.bool, device=a.device)
    for i in range(min(nrows, ncols)):
        cand = torch.where(rows >= i, torch.abs(a[:, i]), -torch.inf)
        p = torch.argmax(cand)
        pivot = torch.abs(a[p, i])
        ok = ok & (pivot >= eps)
        row_i, row_p = a[i].clone(), a[p].clone()
        a[i] = row_p
        a[p] = row_i
        d = torch.where(pivot >= eps, a[i, i], 1.0)   # no div-by-0 on failure
        ri = a[i] / d
        factors = a[:, i].clone()
        factors[i] = 0.0
        a = a - torch.outer(factors, ri)
        a[i] = ri
    return a, ok
