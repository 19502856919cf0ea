"""The image loop where no CUDA graph engages (the CPU): the frame index,
a one-element device tensor, renders the frame a Python int renders, bit
for bit, and as the benchmark's frozen reference renders it; chained
one-frame calls of ``make_imageseq_scan_runner`` equal one multi-frame call
bit for bit, on a tiny wide world where slots are deleted and recruited,
count no graph capture or replay, and write nothing into the state and
templates they are given. The card's graph path is
tests/test_torch_imageseq_graph_cuda.py."""

import os
import sys

import pytest
import torch

from surikatoko_tpu_torch.geom import camera as cam_mod
from surikatoko_tpu_torch.models.monoslam import init_state, make_params
from surikatoko_tpu_torch.utils.profiling import counts
from surikatoko_tpu_torch.world import device_runner as dr

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from benchmark.reference import image as ref_image  # noqa: E402

torch.set_num_threads(2)

K, T = 16, 12
GRAPH_COUNTERS = ("frame.graph_captures", "frame.graph_replays")
RUNNER_KW = dict(templ_width=15, recruit_max=4, detector_corners=16,
                 recruit_depth="local")


def _world(dtype):
    """160x120 with the flagship's field of view, K = 16 slots over 64
    wide-world splats, deletion after 5 unseen frames."""
    cam = cam_mod.make_intrinsics((160, 120), (80.0, 60.0), 1.95,
                                  (0.02, 0.02), dtype=dtype, device="cpu")
    params = make_params(cam, None, dt=1.0, process_noise_lin_veloc_std=0.075,
                         process_noise_ang_veloc_std=0.01,
                         sal_pnt_init_inv_dist=0.5,
                         sal_pnt_init_inv_dist_std=0.5,
                         max_undetected_frames=5, covar_diag_inflation=1e-6,
                         dtype=dtype, device="cpu")
    sc = dr.build_imageseq_scenario(K, dtype=dtype, image_size=(160, 120),
                                    n_points=64, bg_cell=16, max_deviation=0.8,
                                    world="wide", device="cpu")
    state, templates = dr.init_imageseq(
        params, sc, init_state(K, dtype=dtype, device="cpu"), 15)
    return params, sc, state, templates


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("where", ["first", "middle", "last"])
def test_torch_render_frame_tensor_index_renders_the_int_frame(where, dtype):
    params, sc, _, _ = _world(dtype)
    F = sc.gt_cfw_R.shape[0]
    f = {"first": 0, "middle": F // 2, "last": F - 1}[where]
    got = dr.render_frame(params, sc, dr._frame_index(f, "cpu"))
    w = ref_image.ImageWorldT(sc.gt_cfw_R, sc.gt_cfw_t, sc.gt_points,
                              sc.background, sc.splat_amp, sc.splat_sigma)
    assert torch.equal(got, dr.render_frame(params, sc, f))
    assert torch.equal(got, ref_image.render_frame(params, w, f))
    assert not torch.equal(got, sc.background)      # splats in view


@pytest.mark.parametrize("recruit", [True, False])
def test_torch_imageseq_one_frame_calls_equal_a_multi_frame_call_on_cpu(
        recruit):
    """Frames 1-12 from the bootstrap, which claims every slot: a slot goes
    unseen, is deleted after 5 frames and (with recruitment) claimed
    again."""
    params, sc, state, templates = _world(torch.float64)
    run = dr.make_imageseq_scan_runner(params, recruit=recruit,
                                       **(RUNNER_KW if recruit
                                          else {"templ_width": 15}))
    frames = range(1, T + 1)
    before = {c: counts().get(c, 0) for c in GRAPH_COUNTERS}
    want = run(state, templates, sc, frames)
    st, tm, outs, active = state, templates, [], [state.lm_active]
    for f in frames:
        kept = [t.clone() for t in (*st, tm)]
        got = run(st, tm, sc, [f])
        assert all(torch.equal(a, b) for a, b in zip((*st, tm), kept)), f
        if recruit:
            st, tm, out = got
        else:
            st, out = got
        outs.append(out)
        active.append(st.lm_active)
    for name, a, b in zip(dr.MonoSlamState._fields, st, want[0]):
        assert torch.equal(a, b), name
    if recruit:
        assert torch.equal(tm, want[1])
    for i, w in enumerate(want[-1]):
        assert torch.equal(torch.cat([o[i] for o in outs]), w), i
    assert {c: counts().get(c, 0) for c in GRAPH_COUNTERS} == before
    # the regime: every slot starts active, so a slot recruited again
    # (a generation) was deleted first; without recruitment it stays free
    assert bool(state.lm_active.all())
    if recruit:
        assert int(want[-1][3].sum()) > 0                  # n_recruited
        assert int(st.lm_generation.max()) > 0
    else:
        assert any(bool((a & ~b).any()) for a, b in zip(active, active[1:]))
