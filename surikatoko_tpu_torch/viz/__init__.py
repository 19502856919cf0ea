"""Views: 2D overlays, OpenGL-style pose matrices, the 3D scene and the live
run viewer (matplotlib, imported only when a figure is made)."""

from surikatoko_tpu_torch.viz import draw2d as draw2d
from surikatoko_tpu_torch.viz import gl_helpers as gl_helpers
from surikatoko_tpu_torch.viz import scene_view as scene_view
