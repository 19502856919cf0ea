"""Davison MonoSlam EKF (the image-sequence slice's modules)."""

from surikatoko_tpu_torch.models.monoslam.state import (  # noqa: F401
    CAM_STATE_COMPS,
    SAL_PNT_COMPS,
    MonoSlamParams,
    MonoSlamState,
    init_state,
    make_params,
)
