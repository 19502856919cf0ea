"""SE3 <-> OpenGL-style 4x4 matrices and axes conversions.

Port of ``surikatoko_tpu/viz/gl_helpers.py`` (reference
opengl-helpers.{h,cpp}): column-major 4x4 from an SE3, and the
Hartley-Zisserman (x-right, y-down, z-forward) <-> OpenGL (x-right, y-up,
z-backward) axes flip. Host numpy in, host numpy out.
"""

from __future__ import annotations

import numpy as np

from surikatoko_tpu_torch.geom.se3 import SE3
from surikatoko_tpu_torch.io.checkpoint import _host as np_

# diag(1,-1,-1): flips y and z between HZ camera axes and OpenGL eye axes
HZ_FROM_GL = np.diag([1.0, -1.0, -1.0])


def se3_to_gl_mat44(t: SE3) -> np.ndarray:
    """Column-major flat [16] OpenGL modelview from an SE3 (reference
    SE3TransformToOpenGL)."""
    m = np.eye(4)
    m[:3, :3] = np_(t.R)
    m[:3, 3] = np_(t.t)
    return m.T.reshape(-1)  # OpenGL is column-major


def gl_from_hz_camera(cfw: SE3) -> np.ndarray:
    """OpenGL eye matrix for a Hartley-Zisserman camera-from-world pose."""
    m = np.eye(4)
    m[:3, :3] = HZ_FROM_GL @ np_(cfw.R)
    m[:3, 3] = HZ_FROM_GL @ np_(cfw.t)
    return m.T.reshape(-1)
