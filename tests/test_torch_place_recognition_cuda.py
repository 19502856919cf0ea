"""Place recognition and the two-view toolbox on the card against the CPU.
Imports no JAX, so it runs where the card is:

    python -m pytest --noconftest tests/test_torch_place_recognition_cuda.py -m cuda -q

Without a CUDA device it skips (the point is the card's runs).
- Steered BRIEF of the at-scale demo's rendered head and revisit frames
  (bench.py's MVF size) on the card against the CPU: the same tracks, and
  at most 2 flipped bits a descriptor (the card sums the blur and the
  orientation moments in its own order, which can flip a near tie).
- The closure at bench.py's MVF size (2048 points, 128 frames + 12) without
  the oracle, float32 on the card: chip_smoke.py's checks (the loop
  closed, 205 x 205 tracks, 100 +- 2 candidates, >= 3 verified pairs, >= 90%
  of them correct).
- chip_smoke.py's two-view steps in float64 on the card within 1e-9 of the
  CPU on the same samples.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke  # noqa: E402

MAX_FLIPPED_BITS = 2


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the card's runs against the CPU")
    from surikatoko_tpu_torch import config
    config.set_full_precision()


def _bench_world():
    from surikatoko_tpu_torch.demos import mvf_at_scale as mas
    args = mas.make_args(**chip_smoke.MVF_CLOSURE_CHECK, device="cpu")
    w = mas.World(args)
    ts = mas.TrackStore(2 * w.n_pts, w.n_total, 2 * args.track_len)
    for f in range(w.n_total):
        w.write_corners(ts, f)
    return w


@pytest.mark.cuda
def test_torch_track_descriptors_on_card_match_cpu():
    _need_card()
    from surikatoko_tpu_torch.vision import descriptors as desc
    from surikatoko_tpu_torch.vision import place_recognition as pr
    w = _bench_world()
    for obs in (w.head_obs, w.tail_obs):
        card = pr.describe_tracks(obs, device="cuda")
        cpu = pr.describe_tracks(obs, device="cpu")
        np.testing.assert_array_equal(card.tids, cpu.tids)
        np.testing.assert_array_equal(card.count, cpu.count)
        flips = desc.popcount32(torch.bitwise_xor(card.desc.cpu(),
                                                  cpu.desc)).sum(1)
        assert int(flips.max()) <= MAX_FLIPPED_BITS, flips.max()


@pytest.mark.cuda
def test_torch_oracle_free_closure_at_bench_size_on_card():
    _need_card()
    from surikatoko_tpu_torch.demos import mvf_at_scale as mas
    r = mas.run_at_scale(mas.make_args(**chip_smoke.MVF_CLOSURE_CHECK,
                                       device="cuda", dtype=torch.float32))
    prs = r["place_recognition"]
    assert r["loop_closed"] and r["localization_failures"] == 0
    assert (prs["tracks_revisit"], prs["tracks_head"]) == \
        chip_smoke.PR_BENCH_TRACKS
    assert abs(prs["candidates"] - chip_smoke.PR_BENCH_CANDIDATES) <= \
        chip_smoke.PR_BENCH_CANDIDATES_SLACK
    assert r["closure_pairs_total"] >= chip_smoke.PR_MIN_VERIFIED
    assert r["closure_pairs_correct"] >= \
        chip_smoke.PR_MIN_CORRECT_SHARE * r["closure_pairs_total"]


@pytest.mark.cuda
def test_torch_two_view_f64_on_card_matches_cpu():
    _need_card()
    inp = chip_smoke.two_view_inputs()
    card = chip_smoke.two_view_host(chip_smoke.two_view_run(
        inp, "cuda", torch.float64)[0])
    cpu = chip_smoke.two_view_host(chip_smoke.two_view_run(
        inp, "cpu", torch.float64)[0])
    d = chip_smoke.two_view_diff(card, cpu)
    assert all(v == 0 if k.endswith("inliers")
               else v <= chip_smoke.TWO_VIEW_F64_TOL for k, v in d.items()), d
