"""Ground-truth pose helpers of the closed-loop runners.

Port of ``surikatoko_tpu/world/runner.gt_poses_in_tracker_frame``; the
host-driven runner itself is not ported yet (ROADMAP queue A item 9).
"""

from __future__ import annotations

import torch

from surikatoko_tpu_torch.geom.se3 import SE3


def gt_poses_in_tracker_frame(gt_cfw: SE3) -> SE3:
    """Re-express GT camera poses relative to the first camera: the tracker
    origin is camera 0 (reference kTrackerOriginCamInd=0,
    demo-davison-mono-slam.cpp:205)."""
    wfT = SE3(gt_cfw.R[0], gt_cfw.t[0]).inv()
    R = torch.einsum("fij,jk->fik", gt_cfw.R, wfT.R)
    t = torch.einsum("fij,j->fi", gt_cfw.R, wfT.t) + gt_cfw.t
    return SE3(R, t)
