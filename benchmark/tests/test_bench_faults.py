"""Runs of each cell on the CPU at a small size with the harness's look
for a chip skipped: a sound run comes out correct, and a run whose timed
path is broken underneath comes out not correct, once for each fault the
cell can have: a step that returns its state unchanged, half of the batch
left out, an answer altered where it is produced; and a run with one
failed frame in its window. (One chip: no exchange between chips to leave
out.)"""

from __future__ import annotations

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import run  # noqa: E402

SMALL = {"s03_scan": 96, "s03_hostloop": 96, "s03_batch32": 96}


def _edit(workload):
    def edit(spec):
        spec["traffic"].update(warmup_frames=min(spec["traffic"]["warmup_frames"], 40),
                               check_frames=2)
        spec["cfg"]["capacity"] = SMALL[workload]
        if spec["traffic"].get("batch"):
            spec["traffic"].update(batch=4, noise_frames=64)
    return edit


def _run(workload, patch=None, seed=1234567890123):
    return run.run_cell(workload, seed, 1.0, False, device="cpu",
                        edit=_edit(workload), patch=patch)


def _frozen(cell):
    """The step returns the state it was given."""
    inner = cell.run

    def run_(*a):
        return (a[0],) + tuple(inner(*a)[1:])
    cell.run = run_


def _half_batch(cell):
    """Only the first half of the batch steps; the rest keep their state."""
    inner = cell.run

    def run_(state, sc, frames, noise):
        st, *rest = inner(state, sc, frames, noise)
        h = st.x.shape[0] // 2
        keep = lambda new, old: torch.cat([new[:h], old[h:]])
        return (st._replace(**{k: keep(getattr(st, k), getattr(state, k))
                               for k in ("x", "P", "lm_active", "lm_unobserved",
                                         "lm_generation")}), *rest)
    cell.run = run_


def _one_failed_frame(cell):
    """One step of the window reports a failed frame (a state gone NaN
    or an innovation Cholesky that failed), whatever the frames compared
    show."""
    inner, calls = cell.step, []

    def step():
        n, bad = inner()
        calls.append(n)
        return n, bad + (len(calls) == 1)
    cell.step = step


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_sound_run_is_correct(workload):
    out = _run(workload)
    assert out["correct"], out["compared"]
    assert out["failed"] == 0


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_failed_frame_is_not_correct(workload):
    out = _run(workload, _one_failed_frame)
    assert out["failed"] == 1 and not out["correct"]
    assert out["compared"]["failed_frames"] == {"value": 1, "limit": 0}


@pytest.mark.parametrize("workload", ["s03_scan", "s03_batch32"])
def test_unchanged_state_is_caught(workload):
    assert not _run(workload, _frozen)["correct"]


def test_unchanged_state_is_caught_hostloop(monkeypatch):
    from surikatoko_tpu_torch.models.monoslam import filter as filt
    inner = filt._process_frame

    def frozen(params, impl, state, *a):
        return state, inner(params, impl, state, *a)[1]
    monkeypatch.setattr(filt, "_process_frame", frozen)
    assert not _run("s03_hostloop")["correct"]


def test_half_batch_is_caught():
    assert not _run("s03_batch32", _half_batch)["correct"]


@pytest.mark.parametrize("workload", ["s03_scan", "s03_batch32"])
def test_altered_observation_is_caught(workload, monkeypatch):
    """The GT matcher moves one landmark's observation by a pixel."""
    from surikatoko_tpu_torch.world import device_runner as dr
    inner = dr._project_gt

    def moved(*a):
        pix, vis = inner(*a)
        return pix + torch.nn.functional.one_hot(
            torch.tensor(3), pix.shape[0]).to(pix.dtype)[:, None], vis
    monkeypatch.setattr(dr, "_project_gt", moved)
    assert not _run(workload)["correct"]


def test_altered_demo_match_is_caught(monkeypatch):
    """The demo matcher moves one slot's observation by a pixel."""
    from surikatoko_tpu_torch.world.demo_matcher import DemoCornersMatcher
    inner = DemoCornersMatcher.match_salient_points

    def moved(self, state, f):
        obs, mask = inner(self, state, f)
        return obs + torch.nn.functional.one_hot(
            torch.tensor(5), obs.shape[0]).to(obs.dtype)[:, None], mask
    monkeypatch.setattr(DemoCornersMatcher, "match_salient_points", moved)
    assert not _run("s03_hostloop")["correct"]
