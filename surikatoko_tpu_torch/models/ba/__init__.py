"""Kanatani-style bundle adjustment (port of ``surikatoko_tpu/models/ba``).

f0-scaled reprojection error, per-frame variables [fx fy u0 v0 Tx Ty Tz Wx
Wy Wz] (direct camera pose, incremental Rodrigues rotation), gauge fixed by
scene normalization (R0=I, T0=0, |T1c|=1) plus variable pinning, LM with
multiplicative diagonal damping (x10 / /10), and a Schur-complement reduced
camera solve: dense (problem/derivs/schur) for small problems, track-major
with a banded Gram reduction (sparse) for large ones.

Every product here is cuBLAS/cuSOLVER through plain torch ops on the card:
no TPU kernel of the JAX package lies on this path.
"""

from surikatoko_tpu_torch.models.ba.problem import (
    BAProblem as BAProblem,
    make_problem as make_problem,
    reproj_error as reproj_error,
    seen_points_count as seen_points_count,
)
from surikatoko_tpu_torch.models.ba.normalize import (
    normalize_scene as normalize_scene,
    revert_normalization as revert_normalization,
    check_world_is_normalized as check_world_is_normalized,
)
from surikatoko_tpu_torch.models.ba.lm import (
    BundleAdjustment as BundleAdjustment,
    SparseBundleAdjustment as SparseBundleAdjustment,
    TermCriteria as TermCriteria,
)
from surikatoko_tpu_torch.models.ba import sparse as sparse
