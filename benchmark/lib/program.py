"""What the benchmark hands the program under test: its filter
parameters, built by the program's own constructors from a configuration,
and the world as the program's scenario types, on the device."""

from __future__ import annotations

import numpy as np
import torch

from benchmark.lib.world import World


def dtype_of(cfg: dict) -> torch.dtype:
    return getattr(torch, cfg["dtype"])


def params(cfg: dict, dtype, device):
    from surikatoko_tpu_torch.geom import camera
    from surikatoko_tpu_torch.models.monoslam import make_params
    c = cfg["camera"]
    cam = camera.make_intrinsics(c["image_size"], c["principal_point"],
                                 c["focal_length_mm"], c["pixel_size_mm"],
                                 dtype=dtype, device=device)
    return make_params(cam, None, dtype=dtype, device=device, **cfg["filter"])


def _t(a, dtype, device):
    return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)


def gt_scenario(world: World, cfg: dict, dtype, device):
    """The world as the GT-matcher loops' ``DeviceScenario``."""
    from surikatoko_tpu_torch.world.device_runner import DeviceScenario
    return DeviceScenario(
        gt_cfw_R=_t(world.gt_cfw_R, dtype, device),
        gt_cfw_t=_t(world.gt_cfw_t, dtype, device),
        gt_points=_t(world.points, dtype, device),
        image_size=_t([float(v) for v in world.image_size], dtype, device),
        noise_std=_t(cfg["matcher"]["detection_noise_std"], dtype, device))

