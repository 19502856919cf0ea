"""The churned image loop of the benchmark's ``k768_churn`` cell, at a tiny
size on the CPU, against the benchmark's plain float64 reference
(``benchmark/reference/image.py``, which imports nothing of the port):
the port's ``make_imageseq_scan_runner(recruit=True)``, one frame a call
from ``init_imageseq``, stepped from each of its own states.

In float64 every frame's x and P are within 1e-9 of the reference's step
and the matched set, the recruited slots and the active mask are equal,
across deletions and recruitment; the runner writes nothing into the
state and templates it is given. In float32 each frame is within the
cell's limits (``benchmark/limits/k768_churn.json``). And the spans of a
traced frame: each phase of the image frame once, the detection outside
the update. Imports no JAX."""

import json
import os
import sys

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from surikatoko_tpu_torch.models.monoslam import init_state
from surikatoko_tpu_torch.utils import profiling
from surikatoko_tpu_torch.world import device_runner as dr

ROOT = os.path.join(os.path.dirname(__file__), "..")
sys.path.insert(0, ROOT)
from benchmark.lib import program, wide_world  # noqa: E402
from benchmark.lib.cell import state_errs  # noqa: E402
from benchmark.reference import image as ref_image  # noqa: E402
from benchmark.reference import steps as ref_steps  # noqa: E402

torch.set_num_threads(2)
SEED = 2718281829
FRAMES = 40
TOL = 1e-9
PHASES = ("frame.render", "frame.measure", "frame.search", "frame.detect",
          "frame.update", "frame.recruit", "frame.predict")


def _cfg():
    """The cell's configuration cut to K = 16, 160x120 (the same field of
    view), 64 wide-world points and deletion after 5 unseen frames."""
    with open(os.path.join(ROOT, "benchmark", "configs",
                           "monoslam_wide_k768.json")) as f:
        cfg = json.load(f)
    cfg["capacity"] = 16
    cfg["camera"].update(image_size=[160, 120], principal_point=[80.0, 60.0],
                         pixel_size_mm=[0.02, 0.02])
    cfg["world"]["points"] = 64
    cfg["filter"]["max_undetected_frames"] = 5
    return cfg


def _program(cfg, dtype):
    """(params, scenario, runner, state, templates) of the port at frame 0."""
    world = wide_world.build(cfg, SEED)
    t = lambda a: torch.as_tensor(a, dtype=dtype)  # noqa: E731
    sc = dr.ImageSeqDeviceScenario(
        gt_cfw_R=t(world.gt_cfw_R), gt_cfw_t=t(world.gt_cfw_t),
        gt_points=t(world.points), background=t(world.background),
        splat_amp=t(world.splat_amp), splat_sigma=t(world.splat_sigma))
    params = program.params(cfg, dtype, "cpu")
    rc = cfg["runner"]
    run = dr.make_imageseq_scan_runner(
        params, templ_width=rc["templ_width"],
        search_radius=rc["search_radius"], min_corr_coeff=rc["min_corr_coeff"],
        chi2_gate=rc["chi2_gate"], subpixel=rc["subpixel"], recruit=True,
        recruit_max=rc["recruit_max"], detector_corners=rc["detector_corners"],
        detector_quality=rc["detector_quality"],
        detector_nms_radius=rc["detector_nms_radius"],
        recruit_min_dist=rc["recruit_min_dist"],
        recruit_depth=rc["recruit_depth"])
    st, tm = dr.init_imageseq(params, sc, init_state(cfg["capacity"],
                                                     dtype=dtype, device="cpu"),
                              rc["templ_width"])
    return world, sc, run, st, tm


def _reference(cfg, world):
    w = ref_image.world_tensors(world, torch.float64, "cpu")
    return w, ref_steps.params_of(cfg, torch.float64, "cpu")


def _loop(dtype):
    """Every frame of the port's loop with the reference's step from the
    same state: [(pre, templates, post, post templates, reference)], and
    the bootstrap against the reference's."""
    cfg = _cfg()
    world, sc, run, st, tm = _program(cfg, dtype)
    w, rp = _reference(cfg, world)
    start = state_errs(st, ref_image.init_imageseq(
        rp, w, cfg["capacity"], cfg["runner"]["templ_width"])[0])
    out = []
    for f in range(1, FRAMES + 1):
        copies = [t.clone() for t in st] + [tm.clone()]
        st2, tm2, _ = run(st, tm, sc, [f])
        assert all(torch.equal(a, b) for a, b in zip(copies, list(st) + [tm])), f
        ref = ref_image.image_step(rp, w, ref_steps.state_as(st, torch.float64),
                                   tm.to(torch.float64), f, cfg["runner"])
        out.append((st, tm, st2, tm2, ref))
        st, tm = st2, tm2
    return start, out


@pytest.fixture(scope="module")
def loop64():
    return _loop(torch.float64)


def test_float64_equals_the_reference_frame_by_frame(loop64):
    start, frames = loop64
    assert start["x_err"] == 0 and start["P_err"] == 0
    assert start["bookkeeping_mismatch"] == 0
    for f, (pre, _, post, tm2, (ref, ref_tm)) in enumerate(frames, 1):
        e = state_errs(post, ref)
        assert e["x_err"] <= TOL and e["P_err"] <= TOL, (f, e)
        for k in ("lm_active", "lm_unobserved", "lm_generation"):
            assert torch.equal(getattr(post, k), getattr(ref, k)), (f, k)
        fresh = post.lm_generation > pre.lm_generation
        assert torch.allclose(tm2[fresh], ref_tm[fresh], rtol=0, atol=TOL), f


def test_the_run_deletes_and_recruits(loop64):
    _, frames = loop64
    mu = _cfg()["filter"]["max_undetected_frames"]
    deleted = recruited = 0
    for pre, _, post, _, _ in frames:
        gone = pre.lm_active & (pre.lm_unobserved + 1 > mu)
        deleted += int((gone & (post.lm_unobserved > 0)).sum()
                       + (gone & (post.lm_generation > pre.lm_generation)).sum())
        recruited += int((post.lm_generation > pre.lm_generation).sum())
    assert deleted >= 1 and recruited >= 1, (deleted, recruited)


def test_float32_within_the_cells_limits():
    with open(os.path.join(ROOT, "benchmark", "limits",
                           "k768_churn.json")) as f:
        limits = json.load(f)
    _, frames = _loop(torch.float32)
    for f, (_, _, post, _, (ref, _)) in enumerate(frames, 1):
        e = state_errs(post, ref)
        assert all(e[k] <= limits[k] for k in e), (f, e)


def test_a_traced_frame_opens_each_phase_once():
    cfg = _cfg()
    _, sc, run, st, tm = _program(cfg, torch.float64)
    st, tm, _ = run(st, tm, sc, [1])
    with profile(activities=[ProfilerActivity.CPU]):
        run(st, tm, sc, [2, 3])
    spans = profiling.window()
    frames = [i for i, s in enumerate(spans) if s.name == "frame"]
    assert len(frames) == 2

    def ancestors(i):
        while spans[i].parent >= 0:
            i = spans[i].parent
            yield spans[i].name

    for k, top in enumerate(frames):
        end = frames[k + 1] if k + 1 < len(frames) else len(spans)
        names = [s.name for s in spans[top + 1:end]]
        for p in PHASES:
            assert names.count(p) == 1, (p, names)
        for i in range(top + 1, end):
            up = list(ancestors(i))
            assert up[-1] == "frame", (spans[i].name, up)
            if spans[i].name == "frame.detect":
                assert "frame.update" not in up
            if spans[i].name == "b1":
                assert up[0] == "frame.search"
            if spans[i].name == "b2":
                assert up[0] == "frame.predict"
