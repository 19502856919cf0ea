"""Incremental multi-view factorization SfM.

Port of ``surikatoko_tpu/models/mvf`` (reference
``MultiViewIterativeFactorizer``, multi-view-factorization.{h,cpp}): per new
frame, match corners into tracks, anchor on the previous frame sharing the
most points, estimate relative motion from the 3N x 12 Kronecker system (SVD
+ projection onto SO(3), MASKS 8.41-8.44), triangulate newly-complete tracks
by the MASKS 8.44 depth formula, and trigger bundle adjustment when the
reprojection error exceeds a threshold.
"""

from surikatoko_tpu_torch.models.mvf.factorizer import (
    MultiViewFactorizer as MultiViewFactorizer,
    TrackStore as TrackStore,
)
from surikatoko_tpu_torch.models.mvf.relative_motion import (
    find_relative_motion_multi_points as find_relative_motion_multi_points,
    estimate_point_depth as estimate_point_depth,
    refine_pose_pnp as refine_pose_pnp,
)
