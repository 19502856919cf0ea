"""The benchmark's plain reference of one step of the incremental SfM pass
(a keyframe localized, its fresh tracks triangulated, and the sliding-window
or the global bundle adjustment that the step runs): plain PyTorch,
importing nothing of the port and nothing of JAX. It is written from the
published methods, not from the port:

- ``geometry``: rotations, the pinhole projection and the reprojection cost;
- ``pnp``: a keyframe's pose as the Gauss-Newton least-squares optimum of
  its 2D-3D correspondences;
- ``triangulate``: linear (DLT) triangulation, then Gauss-Newton;
- ``ba``: Levenberg-Marquardt with Kanatani's damping schedule, each
  iteration solving the damped normal equations with the points eliminated
  by their 3x3 blocks and the dense reduced camera system factored by
  Cholesky (the textbook Schur complement);
- ``step``: which correspondences, tracks, frames and points a step of the
  pipeline takes, and what it keeps.

The comparison runs it in float64 with TF32 off; the control in float32.
"""
