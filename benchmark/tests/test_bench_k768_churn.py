"""The ``k768_churn`` cell on the CPU at a tiny size, with the harness's
look for a chip skipped: a sound run is correct, and an altered match, an
altered recruit and a step that returns its state unchanged are each
caught; a replay of the window restarts from the warmed state. Its world
against the port's builders, its configuration against the port's
flagship settings, and the readers of its new metrics on synthetic traces
and spans."""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import run  # noqa: E402
from benchmark.lib import program, wide_world  # noqa: E402
from benchmark.lib import world as world_mod  # noqa: E402
from benchmark.lib.trace import Trace  # noqa: E402
from benchmark.lib.work import bound_s, ncc_work  # noqa: E402
from surikatoko_tpu_torch.utils import profiling  # noqa: E402

CELL = "k768_churn"
CFG = json.loads((ROOT / "benchmark" / "configs"
                  / "monoslam_wide_k768.json").read_text())


def _edit(spec):
    """K = 16 at 160x120 (the same field of view), 64 points, deletion
    after 5 unseen frames, frames 22-25 replayed (in the world of SEED,
    frames 22, 23 and 25 recruit); every window step can be compared."""
    c = spec["cfg"]
    c["capacity"] = 16
    c["camera"].update(image_size=[160, 120], principal_point=[80.0, 60.0],
                       pixel_size_mm=[0.02, 0.02])
    c["world"]["points"] = 64
    c["filter"]["max_undetected_frames"] = 5
    spec["traffic"].update(warmup_frames=21, replay_frames=4, check_frames=40)


SEED = 3456789013


def _run(patch=None):
    """One run of 1 s; the cell's samples are kept for the test."""
    cells = []

    def keep(cell):
        cells.append(cell)
        if patch is not None:
            patch(cell)
    out = run.run_cell(CELL, SEED, 1.0, False, device="cpu", edit=_edit,
                       patch=keep)
    out["_samples"] = cells[0].samples
    return out


def _recruited(samples) -> int:
    return sum(int((s.post.lm_generation > s.pre.lm_generation).sum())
               for s in samples)


def test_sound_run_is_correct():
    out = _run()
    assert out["correct"], out["compared"]
    assert out["failed"] == 0 and out["attempted"] >= 1


def test_unchanged_state_is_caught():
    def frozen(cell):
        inner = cell.run
        cell.run = lambda st, tm, sc, fr: (st, *inner(st, tm, sc, fr)[1:])
    assert not _run(frozen)["correct"]


def test_altered_match_is_caught(monkeypatch):
    """The search drops one landmark's match: the matched set differs."""
    from surikatoko_tpu_torch.world import device_runner as dr
    inner = dr.ncc_search

    def dropped(*a, **kw):
        res = inner(*a, **kw)
        k = int(torch.argmax(res.matched.to(torch.int32)))
        return res._replace(matched=res.matched & (torch.arange(
            res.matched.shape[0]) != k))
    monkeypatch.setattr(dr, "ncc_search", dropped)
    out = _run()
    assert not out["correct"]
    assert out["compared"]["bookkeeping_mismatch"]["value"] >= 1


def test_altered_recruit_is_caught(monkeypatch):
    """The closest filter drops the strongest candidate it would keep, so
    a frame recruits another corner (or none)."""
    from surikatoko_tpu_torch.vision import features
    inner = features.filter_out_closest

    def first_dropped(*a, **kw):
        ok = inner(*a, **kw)
        return ok & (torch.arange(ok.shape[0])
                     != torch.argmax(ok.to(torch.int32)))
    monkeypatch.setattr(features, "filter_out_closest", first_dropped)
    out = _run()
    assert _recruited(out["_samples"]) >= 1
    assert not out["correct"]


def test_replays_restart_from_the_warmed_state():
    spec = run.load_cell(CELL)
    _edit(spec)
    spec["traffic"].update(warmup_frames=3, replay_frames=2)
    from benchmark.drivers.imageseq_churn import Cell
    from benchmark.lib.cell import Spans
    cell = Cell(spec["cfg"], spec["traffic"], SEED, "cpu", Spans())
    for _ in range(3):
        cell.step()
    for _ in range(5):
        cell.capture_next()
        assert cell.step() == (1, 0)
        st = cell.state
        assert cell.counts[2] == int(st.lm_active.sum())
        assert cell.counts[1] == int((st.lm_generation
                                      > cell.samples[-1].pre.lm_generation).sum())
    s = cell.samples
    assert [x.f for x in s] == [4, 5, 4, 5, 4]
    assert s[0].pre is cell.warm[0] and s[2].pre is s[0].pre
    assert s[4].templates is cell.warm[1]
    assert torch.equal(s[1].post.x, s[3].post.x)


def test_world_is_the_ports_wide_world():
    """The path, the points' draw and the background equal the port's
    builders' (``build_oscillating_scenario(world="wide")``,
    ``build_imageseq_scenario(bg_cell=48)``) for one generator."""
    from surikatoko_tpu_torch.world import device_runner as dr
    w, p = CFG["world"], CFG["path"]
    sc = dr.build_imageseq_scenario(
        capacity=w["points"], n_points=w["points"], dtype=torch.float64,
        image_size=tuple(CFG["camera"]["image_size"]), seed=7,
        bg_cell=w["bg_cell"], max_deviation=p["max_deviation"], world="wide",
        device="cpu")
    grid = world_mod.grid_points(w["bounds"], w["cell_size"], w["z_ascent"])
    pts_w = wide_world.wide_points(
        np.random.default_rng(0), grid.mean(axis=0), w["points"],
        w["halfwidth"], w["depth"], w["height"])
    R, t = world_mod.oscillating_path(
        grid.mean(axis=0) + np.asarray(p["eye_offset"]), grid.mean(axis=0),
        p["up"], p["max_deviation"], p["periods"], p["shots_per_period"])
    pts = pts_w @ R[0].T + t[0]
    R, t = world_mod.in_tracker_frame(R, t)
    np.testing.assert_allclose(sc.gt_cfw_R.numpy(), R, atol=1e-12)
    np.testing.assert_allclose(sc.gt_cfw_t.numpy(), t, atol=1e-12)
    np.testing.assert_allclose(sc.gt_points.numpy(), pts, atol=1e-12)
    bg = wide_world.smooth_background(np.random.default_rng(7),
                                      *CFG["camera"]["image_size"],
                                      w["bg_cell"], *w["background"])
    np.testing.assert_array_equal(sc.background.numpy(), bg)
    world = wide_world.build(CFG, 99)
    assert len(world.gt_cfw_R) == p["periods"] * p["shots_per_period"]
    assert world.background.shape == (480, 640)


def test_config_is_the_flagship():
    """The filter of ``parallel.parity.flagship_world`` (bench.py:186-236's
    settings) and the camera, number for number."""
    from surikatoko_tpu_torch.parallel.parity import flagship_world
    ref, _ = flagship_world(8, "cpu", n_points=8)
    got = program.params(CFG, ref.process_noise_cov.dtype, "cpu")
    for k in got._fields:
        a, b = getattr(got, k), getattr(ref, k)
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b), k
        elif isinstance(a, tuple):
            for u, v in zip(a, b):
                assert torch.equal(u, v), k
        else:
            assert a == b, k
    assert CFG["capacity"] == 768 and CFG["reduced"] == []


# ---- metric readers on synthetic traces and spans --------------------------

US = 1000


def _trace(kernels, steps=2):
    return Trace(kernels=kernels, device_ops=kernels, window_s=4e-3,
                 busy_s=0.0, idle_gaps=[], top_ops=[], steps=steps)


def _read(name, rec):
    return run.reader(name, ROOT)(rec)


def test_b1_roofline_on_a_synthetic_trace():
    ks = [("ncc_search_kernel(float const*)", 100 * US, 9 * US),
          ("void downdate_kernel<Form<128> >(float*)", 200 * US, 800 * US),
          ("ncc_search_kernel(float const*)", 2100 * US, 11 * US)]
    work = {"b1": dict(K=768, P=29, T=15)}
    got = _read("b1.roofline_pct", {"trace": _trace(ks), "work": work})
    want = 100 * 2 * bound_s(*ncc_work(768, 29, 15)) / 20e-6
    assert got == pytest.approx(want, rel=1e-12)
    assert 5 < got < 15
    assert _read("b1.roofline_pct", {"trace": _trace(ks[1:2]),
                                     "work": work}) is None
    assert _read("b1.roofline_pct", {"trace": None, "work": work}) is None
    assert _read("b1.roofline_pct", {"trace": _trace(ks), "work": {}}) is None


def _frame_spans():
    """Two traced frames of the image loop, each with its phases."""
    S, out = profiling.Span, []
    for k in range(2):
        t0 = 2000 * US * k
        top = len(out)
        out.append(S("frame", -1, t0, t0 + 1900 * US))
        for j, (name, d) in enumerate((("frame.render", 50),
                                       ("frame.measure", 300),
                                       ("frame.search", 120 + 10 * k),
                                       ("frame.detect", 400 + 20 * k),
                                       ("frame.update", 500))):
            a = t0 + 360 * US * j
            out.append(S(name, top, a, a + d * US))
            if name == "frame.search":
                out.append(S("b1", len(out) - 1, a + 10 * US, a + 20 * US))
    return out


@pytest.mark.parametrize("name,span,span_ms", [
    ("search.ms_per_frame", "frame.search", (0.120 + 0.130) / 2),
    ("detect.ms_per_frame", "frame.detect", (0.400 + 0.420) / 2)])
def test_phase_readers_on_synthetic_spans(name, span, span_ms, monkeypatch):
    monkeypatch.setattr(profiling, "window", _frame_spans)
    assert _read(name, {"trace": _trace([])}) == pytest.approx(span_ms)
    assert _read(name, {"trace": None}) is None
    monkeypatch.setattr(profiling, "window", lambda: [])
    assert _read(name, {"trace": _trace([])}) is None
    monkeypatch.setattr(profiling, "window", lambda: [
        s._replace(name="frame.recruit") if s.name == span else s
        for s in _frame_spans()])
    assert _read(name, {"trace": _trace([])}) is None


def test_manifest_entries_of_the_cell():
    man = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = {w["name"]: w for w in man["workloads"]}[CELL]
    assert cell == {**cell, "config": "monoslam_wide_k768",
                    "traffic": "imageseq_churn", "chips": 1}
    cfgs = {c["name"]: c for c in man["configs"]}
    assert cfgs["monoslam_wide_k768"]["reduced"] == []
    per = {m["name"]: m for m in man["per_layer"]}
    for m in ("b1.roofline_pct", "search.ms_per_frame", "detect.ms_per_frame"):
        assert per[m]["workloads"] == [CELL]
    for m in ("b2.roofline_pct", "device.idle_pct",
              "device.launches_per_frame", "frame.mfu",
              "frame.host_syncs_per_frame", "frame.sync_wait_ms_per_frame",
              "update.host_ms_per_frame", "update.device_ms_per_frame"):
        assert per[m]["workloads"][-1] == CELL
    traffic = json.loads((ROOT / "benchmark" / "traffic"
                          / "imageseq_churn.json").read_text())
    assert traffic["warmup_frames"] == traffic["replay_frames"] == 120
    assert (traffic["warmup_frames"] + traffic["replay_frames"]
            < CFG["path"]["periods"] * CFG["path"]["shots_per_period"])
