"""Two-view geometry: homography DLT and decomposition, fundamental 8- and
7-point, the essential matrix with pose extraction by cheirality and a
Sampson polish, the minimal 5-point solver, optimal correspondence
correction, auto-calibration, and a batched RANSAC engine (all hypotheses
fitted and scored as one batch).

Port of ``surikatoko_tpu/models/sfm``.
"""

from surikatoko_tpu_torch.models.sfm import autocalib as autocalib
from surikatoko_tpu_torch.models.sfm import five_point as five_point
from surikatoko_tpu_torch.models.sfm import mvg as mvg
from surikatoko_tpu_torch.models.sfm import optimal_triangulation as optimal_triangulation
from surikatoko_tpu_torch.models.sfm import ransac as ransac
