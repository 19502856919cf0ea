"""Appearance-based place recognition for loop closure.

Port of ``surikatoko_tpu/vision/place_recognition.py``: re-detected revisit
tracks are matched against head-region landmarks by image appearance alone
(steered-BRIEF descriptors, one per track, mutual-NN Hamming matching with
a ratio test), and a similarity RANSAC over the 3-D map positions of the
candidate pairs verifies them. The surviving pairs feed
``MultiViewFactorizer.close_loop_sim3``.

A group's images go to the device as one copy and its keypoints as
another; its frames are described there one by one and the group's track
descriptors gathered there: nothing is read back until the matcher reads
its mask and indices, once. Spans (``utils.profiling``): ``pr.describe``,
``pr.match`` and ``pr.ransac``, one a call.
"""

from __future__ import annotations

from typing import Iterable, NamedTuple, Sequence

import numpy as np
import torch

from surikatoko_tpu_torch import config
from surikatoko_tpu_torch.geom.align import apply_similarity, umeyama_similarity
from surikatoko_tpu_torch.models.sfm import ransac as ransac_mod
from surikatoko_tpu_torch.ops.transfer import fetch, send
from surikatoko_tpu_torch.utils.profiling import span, spanned
from surikatoko_tpu_torch.vision import descriptors as desc_mod


class TrackDescriptors(NamedTuple):
    tids: np.ndarray      # [T] track ids (unique, ascending)
    desc: torch.Tensor    # [T, N_WORDS] int32 packed steered-BRIEF words
    count: np.ndarray     # [T] observations aggregated per track


@spanned("pr.describe")
def describe_tracks(frames: Iterable[tuple[np.ndarray, np.ndarray,
                                           Sequence[int]]],
                    device: torch.device | str = "cuda") -> TrackDescriptors:
    """One steered-BRIEF descriptor per track over a frame group.

    ``frames`` yields (image [H,W], keypoints [K,2] pixel (x,y), track_ids
    [K]). Each frame's keypoints are described in one batched call on
    ``device``; per track the FIRST observation's descriptor is kept."""
    frames = [(im, kp, t) for im, kp, t in frames if len(t)]
    if not frames:
        return TrackDescriptors(
            np.zeros((0,), np.int64),
            torch.zeros((0, desc_mod.N_WORDS), dtype=torch.int32,
                        device=device), np.zeros((0,), np.int64))
    # np.unique's return_index is each id's first occurrence
    tids, first, count = np.unique(
        np.concatenate([np.asarray(t, np.int64) for _, _, t in frames]),
        return_index=True, return_counts=True)
    images = send(device, torch.float32, *(im for im, _, _ in frames))
    kps = send(device, torch.float64, *(kp for _, kp, _ in frames), first)
    first = kps.pop().to(torch.int64)
    descs = [desc_mod.compute_oriented_brief(
        img, kp, torch.ones(kp.shape[0], dtype=torch.bool, device=device))[0]
        for img, kp in zip(images, kps)]
    return TrackDescriptors(tids, torch.cat(descs)[first],
                            count.astype(np.int64))


@spanned("pr.match")
def match_track_groups(a: TrackDescriptors, b: TrackDescriptors,
                       max_distance: int = 64, ratio: float = 0.85
                       ) -> list[tuple[int, int]]:
    """Mutual-NN + ratio Hamming matching between two track groups.
    Returns candidate (tid_a, tid_b) pairs (appearance only: verify them
    with :func:`ransac_similarity_pairs` on their 3-D positions)."""
    if a.tids.size == 0 or b.tids.size == 0:
        return []
    dev = a.desc.device
    va = torch.ones(a.tids.size, dtype=torch.bool, device=dev)
    vb = torch.ones(b.tids.size, dtype=torch.bool, device=dev)
    m = desc_mod.match_descriptors(a.desc, b.desc, va, vb,
                                   max_distance=max_distance, ratio=ratio)
    good, idx_b = fetch(m.good.to(torch.int64), m.idx_b)
    return [(int(a.tids[i]), int(b.tids[idx_b[i]]))
            for i in np.nonzero(good)[0]]


@spanned("pr.ransac")
def ransac_similarity_pairs(A: np.ndarray, B: np.ndarray, threshold: float,
                            generator: torch.Generator | None = None,
                            iterations: int = 256, *,
                            samples: torch.Tensor | None = None,
                            device: torch.device | str = "cuda",
                            dtype: torch.dtype | None = None) -> np.ndarray:
    """Similarity-RANSAC verification of candidate 3-D correspondences.

    Fits s, R, t (Umeyama on minimal 3-point samples, all hypotheses as one
    batch) mapping A -> B; returns the [N] bool inlier mask of the best
    consensus (squared residual < threshold^2). The samples [M, 3] come
    from ``samples``, else ``iterations`` draws from ``generator`` (default:
    a CPU generator seeded 0)."""
    dtype = dtype or config.default_dtype(device)
    n = int(np.shape(A)[0])
    if n < 3:
        return np.zeros((n,), bool)
    if samples is None and generator is None:
        generator = torch.Generator().manual_seed(0)
    if samples is None:
        samples = ransac_mod.draw_samples(generator, n, 3, iterations)
    # positions and samples as one copy (the indices are exact in float64)
    A, B, idx = send(device, torch.float64, A, B, samples)
    A, B, idx = A.to(dtype), B.to(dtype), idx.to(torch.int64)

    def fit(idx):
        s, R, t = umeyama_similarity(A[idx], B[idx])
        return torch.cat([s[:, None], R.reshape(-1, 9), t], dim=1)

    def resid(models):
        s, R, t = models[:, 0], models[:, 1:10].reshape(-1, 3, 3), models[:, 10:]
        return torch.sum((apply_similarity(s, R, t, A) - B) ** 2, dim=-1)

    out = ransac_mod.ransac(n, 3, fit, resid, threshold=threshold ** 2,
                            samples=idx)
    with span("host_read"):
        return out.inliers.cpu().numpy()


def verify_loop_pairs(cand: list[tuple[int, int]],
                      positions: dict[int, np.ndarray],
                      ransac_threshold: float, **ransac_kw
                      ) -> list[tuple[int, int]]:
    """The candidates whose both tracks have a position and that survive
    :func:`ransac_similarity_pairs` on those positions (``ransac_kw`` goes
    to it)."""
    cand = [(ta, hb) for ta, hb in cand if ta in positions and hb in positions]
    if len(cand) < 3:
        return []
    A = np.stack([positions[a] for a, _ in cand])
    B = np.stack([positions[b] for _, b in cand])
    inl = ransac_similarity_pairs(A, B, ransac_threshold, **ransac_kw)
    return [p for p, ok in zip(cand, inl) if ok]


def find_loop_pairs(tail: TrackDescriptors, head: TrackDescriptors,
                    positions: dict[int, np.ndarray],
                    ransac_threshold: float,
                    max_distance: int = 64, ratio: float = 0.85,
                    **ransac_kw) -> list[tuple[int, int]]:
    """Full pipeline: appearance candidates -> similarity-RANSAC inliers.

    ``positions`` maps track id -> current (drifted) 3-D map position; pairs
    whose either side has no position are dropped. Returns verified
    (tail_tid, head_tid) pairs ready for close_loop_sim3(pairs=...).
    ``ransac_kw`` goes to :func:`ransac_similarity_pairs` (the device is
    the descriptors' unless given)."""
    ransac_kw.setdefault("device", tail.desc.device)
    cand = match_track_groups(tail, head, max_distance=max_distance,
                              ratio=ratio)
    return verify_loop_pairs(cand, positions, ransac_threshold, **ransac_kw)
