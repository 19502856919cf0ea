"""The GT-matcher scan runners where no CUDA graph engages (the CPU):
chained one-frame calls equal one multi-frame call bit for bit and count no
graph capture or replay; the GT matcher's frame index, a one-element device
tensor, selects the pose that a Python int selects. The card's graph path
is tests/test_torch_scan_graph_cuda.py."""

import pytest
import torch

from surikatoko_tpu_torch.geom import camera as cam_mod
from surikatoko_tpu_torch.models.monoslam import init_state, make_params
from surikatoko_tpu_torch.utils.profiling import counts
from surikatoko_tpu_torch.world import device_runner as dr

torch.set_num_threads(2)

K, T, B = 16, 6, 3
GRAPH_COUNTERS = ("frame.graph_captures", "frame.graph_replays")


def _world(dtype):
    cam = cam_mod.make_intrinsics((320, 240), (160.0, 120.0), 1.95,
                                  (0.01, 0.01), dtype=dtype, device="cpu")
    params = make_params(cam, None, dt=1.0, process_noise_lin_veloc_std=0.075,
                         process_noise_ang_veloc_std=0.01, dtype=dtype,
                         device="cpu")
    sc = dr.build_oscillating_scenario(capacity=K, dtype=dtype, device="cpu")
    g = torch.Generator().manual_seed(7)
    state = dr.init_with_gt_landmarks(
        params, sc, init_state(K, dtype=dtype, device="cpu"),
        torch.randn(K, 2, generator=g, dtype=dtype))
    return params, sc, state, g


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("batched", [False, True])
def test_torch_one_frame_calls_equal_a_multi_frame_call_on_cpu(batched, dtype):
    params, sc, state, g = _world(dtype)
    noise = torch.randn((B, T, K, 2) if batched else (T, K, 2), generator=g,
                        dtype=dtype)
    if batched:         # a leading B from the start, as after the first call
        state = dr.MonoSlamState(*(t.expand(B, *t.shape).clone()
                                   for t in state))
    run = (dr.make_batched_scan_runner if batched
           else dr.make_scan_runner)(params, 1)
    frames = range(1, T + 1)
    before = {c: counts().get(c, 0) for c in GRAPH_COUNTERS}
    want = run(state, sc, frames, noise)
    st, outs = state, []
    for t, f in enumerate(frames):
        st, *out = run(st, sc, [f], noise[:, t:t + 1] if batched
                       else noise[t:t + 1])
        outs.append(out)
    for a, b in zip(st, want[0]):
        assert torch.equal(a, b)
    for i, w in enumerate(want[1:]):
        assert torch.equal(torch.cat([o[i] for o in outs], int(batched)), w)
    assert {c: counts().get(c, 0) for c in GRAPH_COUNTERS} == before


@pytest.mark.parametrize("where", ["first", "middle", "last"])
def test_torch_project_gt_tensor_index_selects_the_int_pose(where):
    params, sc, _, g = _world(torch.float64)
    F = sc.gt_cfw_R.shape[0]
    f = {"first": 0, "middle": F // 2, "last": F - 1}[where]
    noise = 0.5 * torch.randn(K, 2, generator=g, dtype=torch.float64)
    pix, vis = dr._project_gt(params, sc, dr._frame_index(f, "cpu"), noise)
    xc = sc.gt_points @ sc.gt_cfw_R[f].T + sc.gt_cfw_t[f]
    want = cam_mod.project_camera_point(params.cam, None, xc) + noise
    w, h = sc.image_size
    want_vis = ((xc[:, 2] > 1e-6) & (want[:, 0] >= 0) & (want[:, 0] < w)
                & (want[:, 1] >= 0) & (want[:, 1] < h)
                & torch.isfinite(want).all(dim=-1))
    assert torch.equal(pix, want) and torch.equal(vis, want_vis)
    assert 0 < int(vis.sum()) <= K
