"""Davison MonoSlam EKF: state, measurement, predict, the four update
strategies, health, the fused steps and the host-driven filter."""

from surikatoko_tpu_torch.models.monoslam.state import (  # noqa: F401
    CAM_STATE_COMPS,
    SAL_PNT_COMPS,
    MonoSlamParams,
    MonoSlamState,
    init_state,
    make_params,
)
from surikatoko_tpu_torch.models.monoslam.filter import (  # noqa: F401,E402
    MonoSlamFilter,
)
