"""The multi-view factorization demo on the card against the same runs on
the CPU. Imports no JAX, so it runs where the card is:

    python -m pytest --noconftest tests/test_torch_mvf_cuda.py -m cuda -q

Without a CUDA device it skips (the point is the card's float64 and
float32 runs). chip_smoke.py's mvf_demo cases (the grid world, the
rectangular path, 12 frames; noise 0 and 0.5 px, each without and with the
SE(3) pose-graph closure): float64 on the card within 1e-9 of the CPU
(poses and map), point counts, ba_runs and each BA's kind, ok, stop reason
and iterations equal; float32 point and camera ATE within 2 x float64's +
0.01; the closure lowers the last camera's error where the run drifted."""

import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke  # noqa: E402


@pytest.mark.cuda
@pytest.mark.parametrize("noise,closure", chip_smoke.MVF_DEMO_CASES)
def test_torch_mvf_demo_on_card_matches_cpu(noise, closure):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the card's float64 and float32 "
                    "runs against the CPU")
    from surikatoko_tpu_torch import config
    config.set_full_precision()
    case = chip_smoke.mvf_demo_case("cuda", noise, closure)
    assert all(case["checks"].values()), case
