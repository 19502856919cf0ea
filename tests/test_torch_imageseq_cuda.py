"""The host-driven image loop on the card against the same loop on the CPU.
Imports no JAX, so it runs where the card is:

    python -m pytest --noconftest tests/test_torch_imageseq_cuda.py -m cuda -q

Without a CUDA device it skips (kernel B1 has no CPU mode). chip_smoke.py's
image loop (the grid world of bench.py:371-473, 320x240, K = 48) for 10
frames written as PGM and read back through FrameLoader, in float64, through
run_image_sequence and run_image_sequence_pipelined: frame by frame the
obs, new and deleted counts and the new slots equal the CPU's, and B1 and
B2 launch once a frame."""

import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke  # noqa: E402

FRAMES = 10


@pytest.mark.cuda
@pytest.mark.parametrize("pipelined", [False, True])
def test_torch_image_sequence_on_card_matches_cpu(tmp_path, pipelined):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: kernel B1 has no CPU mode")
    from surikatoko_tpu_torch.utils.profiling import counts
    chip_smoke.write_imageseq(str(tmp_path), FRAMES)
    c0 = counts()
    card = chip_smoke.imageseq_run(str(tmp_path), "cuda", torch.float64,
                                   pipelined=pipelined)
    assert chip_smoke.launches_since(c0) == {"ncc_search": FRAMES,
                                             "symmetric_downdate": FRAMES}
    cpu = chip_smoke.imageseq_run(str(tmp_path), "cpu", torch.float64,
                                  pipelined=pipelined)
    assert card[3] and cpu[3]
    assert len(card[1]) == len(cpu[1]) == FRAMES
    for f, (a, b) in enumerate(zip(card[1], cpu[1])):
        for name in ("obs_count", "new_count", "deleted_count",
                     "estimated_count"):
            assert int(getattr(a, name)) == int(getattr(b, name)), (f, name)
        assert torch.equal(a.new_slots.cpu(), b.new_slots), f
    assert torch.equal(card[0].P, card[0].P.T)
    assert int(card[1][0].new_count) > 0
    assert max(int(s.obs_count) for s in card[1]) > 0
