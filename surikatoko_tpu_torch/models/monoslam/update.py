"""Products with the block-sparse observation matrix H.

Port of the slice's part of ``surikatoko_tpu/models/monoslam/update.py``:
A = H P and T = A H^T from the per-slot blocks Hcam [K,2,13] / Hlm [K,2,6].
Small K materializes H densely; at K >= 256 landmarks are grouped g at a time
(g = 64 first) and the landmark half becomes one batched matmul
[K/g, 2g, 6g] x [K/g, 6g, D], skipping the [2K, 6K] sea of zero blocks.
The sequential update strategies (impls 2-4) wait in ROADMAP queue A item 8.
"""

from __future__ import annotations

import torch

from surikatoko_tpu_torch.models.monoslam import measure
from surikatoko_tpu_torch.models.monoslam.state import (
    CAM_STATE_COMPS,
    MonoSlamParams,
)

_N = CAM_STATE_COMPS


def _masked_jacobians(params: MonoSlamParams, x: torch.Tensor,
                      obs_mask: torch.Tensor):
    h, Hcam, Hlm = measure.measurement_jacobians(params, x)
    m = obs_mask[:, None, None].to(x.dtype)
    return h, Hcam * m, Hlm * m


def _dense_h(Hcam: torch.Tensor, Hlm: torch.Tensor) -> torch.Tensor:
    """H [2K, 13+6K] from the per-slot blocks."""
    K = Hcam.shape[0]
    eye = torch.eye(K, dtype=Hcam.dtype, device=Hcam.device)
    lm_block = torch.einsum("kij,kl->kilj", Hlm, eye).reshape(2 * K, 6 * K)
    return torch.cat([Hcam.reshape(2 * K, _N), lm_block], dim=1)


def _h_group(K: int) -> int:
    """Landmark-group size of the blocked products, or 0 for dense."""
    if K < 256:
        return 0
    for g in (64, 128, 32):
        if K % g == 0:
            return g
    return 0


def _lm_blocks(Hlm: torch.Tensor, g: int) -> torch.Tensor:
    """Block-diagonal H landmark groups [K/g, 2g, 6g]."""
    G = Hlm.shape[0] // g
    eye = torch.eye(g, dtype=Hlm.dtype, device=Hlm.device)
    return torch.einsum("maij,ab->maibj", Hlm.reshape(G, g, 2, 6),
                        eye).reshape(G, 2 * g, 6 * g)


def hp_blocked(Hcam: torch.Tensor, Hlm: torch.Tensor, P: torch.Tensor,
               group: int) -> torch.Tensor:
    """A = H P [2K, D] as a camera matmul plus one grouped bmm."""
    K, D = Hcam.shape[0], P.shape[-1]
    G = K // group
    P_lm = P[_N:, :].reshape(G, 6 * group, D)
    A_lm = torch.bmm(_lm_blocks(Hlm, group), P_lm).reshape(2 * K, D)
    return Hcam.reshape(2 * K, _N) @ P[:_N, :] + A_lm


def aht_blocked(A2: torch.Tensor, Hcam: torch.Tensor, Hlm: torch.Tensor,
                group: int) -> torch.Tensor:
    """T = A H^T [2K, 2K] with the same grouped block-diagonal structure."""
    K = Hcam.shape[0]
    G = K // group
    A_lm = A2[:, _N:].reshape(2 * K, G, 6 * group).transpose(0, 1)
    T_lm = torch.bmm(A_lm, _lm_blocks(Hlm, group).transpose(1, 2))
    T_lm = T_lm.transpose(0, 1).reshape(2 * K, 2 * K)
    return A2[:, :_N] @ Hcam.reshape(2 * K, _N).T + T_lm


def hp_auto(Hcam: torch.Tensor, Hlm: torch.Tensor, P: torch.Tensor
            ) -> torch.Tensor:
    """A = H P [2K, D]: blocked at large K, dense otherwise."""
    g = _h_group(Hcam.shape[0])
    if g:
        return hp_blocked(Hcam, Hlm, P, g)
    return _dense_h(Hcam, Hlm) @ P


def aht_auto(A2: torch.Tensor, Hcam: torch.Tensor, Hlm: torch.Tensor
             ) -> torch.Tensor:
    """T = A H^T [2K, 2K]: blocked at large K, dense otherwise."""
    g = _h_group(Hcam.shape[0])
    if g:
        return aht_blocked(A2, Hcam, Hlm, g)
    return A2 @ _dense_h(Hcam, Hlm).T
