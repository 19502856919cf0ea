"""The control on the card: the reference put in the program's place in
float32 with TF32, at the cell's own size, has to come out not correct (a
number above its limit, or a step with no number), while the program on
the same frames comes out correct. Card only: TF32 does not exist on the
CPU."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import run  # noqa: E402


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["s03_scan", "s03_hostloop",
                                      "s03_batch32"])
def test_control_is_not_correct(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = run.run_cell(workload, 2400000017, 10.0, False, control=True)
    limits = run.load_cell(workload)["limits"]
    ctrl = out["_control"]
    print(workload, "program", out["_readings"], "control", ctrl)
    assert out["correct"], out["compared"]
    assert ctrl["nonfinite_steps"] > 0 or any(
        v > limits[k] for k, v in ctrl.items() if k in limits), ctrl
