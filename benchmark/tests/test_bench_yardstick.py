"""The yardstick on the CPU: the work arithmetic, the trace reduction and
every metric reader on synthetic events, the world builder, the plain
reference at a tiny K, and a cell added as files being found."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import run  # noqa: E402
from benchmark.lib import trace, work  # noqa: E402
from benchmark.lib import world as world_mod  # noqa: E402
from benchmark.reference import steps  # noqa: E402


def test_work_matches_the_kernel_table():
    """PERF.md's kernel table: 1.640e10 FMA for B2 at (4621, 1536) and
    3.888e7 for B1 at (768, 15, 15); bounds 0.490 ms and 1.16 us."""
    fma, nbytes = work.downdate_work(4621, 1536)
    assert fma == pytest.approx(1.640e10, rel=1e-3)
    assert work.bound_s(fma, nbytes) == pytest.approx(0.490e-3, rel=2e-3)
    fma, nbytes = work.ncc_work(768, 29, 15)
    assert fma == 3.888e7
    assert work.bound_s(fma, nbytes) == pytest.approx(1.16e-6, rel=1e-2)
    assert work.downdate_work(589, 192, B=32)[0] == 32 * 589 * 590 / 2 * 192


def _events():
    """A window of 2 ms with two steps: B2 (pad + downdate) and B1 kernels,
    a copy, and host ops; 0.6 ms of device time, overlapping kernels."""
    us = 1000
    return [
        (trace.WINDOW_SPAN, "host", 0, 2000 * us),
        ("loop", "host", 10 * us, 900 * us),
        ("aten::mm", "host", 20 * us, 30 * us),
        ("pose_read", "host", 950 * us, 1000 * us),
        ("void pad_rows(float const*)", "kernel", 100 * us, 50 * us),
        ("void downdate_kernel<Form<128> >(float*)", "kernel", 150 * us, 200 * us),
        ("void elementwise_kernel<float>(float*)", "kernel", 300 * us, 100 * us),
        ("Memcpy DtoH (Device -> Pinned)", "copy", 1800 * us, 100 * us),
        ("void downdate_kernel<Form<128> >(float*)", "kernel", 1200 * us, 150 * us),
        ("outside", "kernel", 3000 * us, 10 * us),
    ]


def _record(t, workd=None, spans=None):
    return dict(trace=t, work=workd or {}, spans=spans or {}, steady=[0, 1],
                latencies=[0.5, 0.5], frames=2, seconds=1.0, setup_s=3.0)


def test_trace_reduction():
    t = trace.reduce(_events(), steps=2)
    assert t.window_s == pytest.approx(2e-3)
    # union: [100, 400) + [1200, 1350) + [1800, 1900) us
    assert t.busy_s == pytest.approx(550e-6)
    assert len(t.kernels) == 4 and len(t.device_ops) == 5
    gaps = dict(t.idle_gaps)
    # gaps [0,100) [400,1200) [1350,1800) [1900,2000), each charged to the
    # innermost host op open when it began
    assert gaps["(host, outside any operation)"] == pytest.approx(100e-6)
    assert gaps["loop"] == pytest.approx(800e-6)
    assert gaps["pose_read"] == pytest.approx((450 + 100) * 1e-6)
    assert t.top_ops[0][0].startswith("void downdate_kernel")


def test_readers_on_synthetic_events():
    t = trace.reduce(_events(), steps=2)
    w = {"b2": dict(B=1, D=4621, m=1536), "frame_fma": 1e9}
    rec = _record(t, w, {"loop": [0.002, 0.004]})
    read = lambda n: run.reader(n)(rec)
    b2 = 2 * work.bound_s(*work.downdate_work(4621, 1536)) / 400e-6
    assert read("b2.roofline_pct") == pytest.approx(100 * b2)
    assert read("device.idle_pct") == pytest.approx(100 * (1 - 550 / 2000))
    assert read("device.launches_per_frame") == 2.0
    assert read("loop.host_ms_per_frame") == pytest.approx(3.0)
    assert read("matcher.ms_per_frame") is None
    # two traced steps of 1e9 FMAs in the trace's 2 ms window
    assert read("frame.mfu") == pytest.approx(100 * 2e9 / 2e-3 / work.F32_FMA_PER_S)
    assert read("fps") == 2.0 and read("setup_s") == 3.0
    assert read("frame_ms_p95") == pytest.approx(500.0)
    # nothing to read: no value, never 0
    empty = _record(trace.reduce([(trace.WINDOW_SPAN, "host", 0, 10)], 1))
    for n in ("b2.roofline_pct", "device.idle_pct",
              "device.launches_per_frame"):
        assert run.reader(n)(empty) is None


def test_world_follows_the_seed_and_the_path():
    cfg = run.load_cell("s03_scan")["cfg"]
    a, b = world_mod.build(cfg, 7), world_mod.build(cfg, 7)
    c = world_mod.build(cfg, 2**31 + 5)
    assert np.array_equal(a.points, b.points)
    assert not np.array_equal(a.points, c.points)
    assert a.gt_cfw_R.shape == (16000, 3, 3) and a.points.shape == (96, 3)
    # the path: the first pose is the tracker origin, period 160
    assert np.allclose(a.gt_cfw_R[0], np.eye(3)) and np.allclose(a.gt_cfw_t[0], 0)
    assert np.allclose(a.gt_cfw_t[160], a.gt_cfw_t[0], atol=1e-12)
    from surikatoko_tpu_torch.world.device_runner import build_oscillating_scenario
    port = build_oscillating_scenario(96, torch.float64, device="cpu")
    assert np.allclose(port.gt_cfw_R.numpy(), a.gt_cfw_R[:320], atol=1e-12)
    assert np.allclose(port.gt_cfw_t.numpy(), a.gt_cfw_t[:320], atol=1e-12)


def _tiny(cfg, K):
    cfg = json.loads(json.dumps(cfg))
    cfg["capacity"] = K
    return cfg


def test_reference_runs_at_a_tiny_k():
    cfg = _tiny(run.load_cell("s03_scan")["cfg"], 8)
    f64 = torch.float64
    w = steps.world_tensors(world_mod.build(cfg, 3), cfg, f64, "cpu")
    p = steps.params_of(cfg, f64, "cpu")
    noise = torch.zeros((8, 2), dtype=f64)
    st = steps.init_gt(p, w, 8, noise, 0.5)
    st2 = steps.gt_step(p, w, st, 1, noise, 0.5)
    assert torch.equal(st2.P, st2.P.T) and torch.isfinite(st2.x).all()
    assert not torch.equal(st2.x, st.x)
    mc = dict(cfg["matcher"], max_new_per_frame=4, max_new_in_first_frame=8)
    book = steps.MatcherBook(np.random.default_rng(5).bit_generator.state,
                             np.full(8, -1), np.full(len(w.points), -1))
    st, s2f = steps.hostloop_step(p, w, steps.init_from_gt(w, 8, 1.0), 0,
                                  book, mc)
    assert int(st.lm_active.sum()) == 8 and (s2f >= 0).sum() == 8
    assert torch.isfinite(st.P).all()


def test_reservoir_draws_from_the_whole_window():
    """The compared steps: as many as asked, from the seed, spread over
    however many steps the window held, the late ones too."""
    def drawn(seed, steps):
        r = run.Reservoir(seed, 6)
        for k in range(steps):
            r.slot(k)
        return sorted(r.steps)
    assert drawn(2**31 + 11, 4) == [0, 1, 2, 3]
    a = drawn(2**31 + 11, 10000)
    assert a == drawn(2**31 + 11, 10000) != drawn(2**31 + 12, 10000)
    assert len(set(a)) == 6 and max(a) > 5000
    late = [max(drawn(s, 10000)) for s in range(40)]
    assert sum(m > 9000 for m in late) >= 10


def test_a_cell_added_as_files_is_found(tmp_path):
    """A new traffic file, a limits file and a manifest entry: found and
    run without editing any file the benchmark has."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    man = json.loads((ROOT / "BENCHMARK.json").read_text())
    man["workloads"].append({"name": "s03_scan_short", "config": "monoslam_s03_k96",
                             "traffic": "gt_scan_short", "chips": 1,
                             "why": "a cell added as data"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    traffic = json.loads((ROOT / "benchmark/traffic/gt_scan.json").read_text())
    traffic.update(warmup_frames=2, check_frames=1)
    (tmp_path / "benchmark/traffic/gt_scan_short.json").write_text(
        json.dumps(traffic))
    (tmp_path / "benchmark/limits/s03_scan_short.json").write_text(
        (ROOT / "benchmark/limits/s03_scan.json").read_text())
    spec = run.load_cell("s03_scan_short", tmp_path)
    assert spec["traffic"]["warmup_frames"] == 2
    assert {m["name"] for m in spec["end_to_end"]} == {"fps", "frame_ms_p95",
                                                       "setup_s"}
    out = run.run_cell("s03_scan_short", 11, 0.5, False, device="cpu",
                       root=tmp_path)
    assert out["attempted"] >= 1 and "fps" in out["metrics"]
