"""The yardstick's arithmetic: operations and bytes of the kernels and of a
whole filter frame, counted from shapes, and the published peaks of the
card they are divided by.

``downdate_work`` and ``ncc_work`` are copies of chip_smoke.py's: each
input read once, each output written once, whatever the kernel reads again.
"""

from __future__ import annotations

# NVIDIA H100 SXM (data sheet; dense rates at the 700 W limit): float32
# FMAs outside the tensor cores, 132 SMs x 128 lanes at the 1.98 GHz boost
# clock; HBM3 bandwidth.
F32_FMA_PER_S = 132 * 128 * 1.98e9
HBM_BYTES_PER_S = 3.35e12


def downdate_work(D: int, m: int, with_keep: bool = True, B: int = 1,
                  elem: int = 4) -> tuple[float, float]:
    """(FMAs, bytes) of B downdates P' = kk^T o (P - M^T M) of [D,D]: the
    lower triangle's D(D+1)/2 m FMAs; P's lower half, M and keep read once,
    the [D,D] output written."""
    fma = D * (D + 1) / 2 * m
    nbytes = elem * (D * (D + 1) / 2 + m * D + (D if with_keep else 0)
                     + D * D)
    return B * fma, B * nbytes


def ncc_work(K: int, P: int, T: int, B: int = 1) -> tuple[float, float]:
    """(FMAs, bytes) of the gated NCC search over K landmarks: the K S^2
    T^2 products of the cross-correlation (window sums take O(P^2) with
    prefix sums); the [K,P,P] patches, [K,T,T] templates (float32) and
    [K,S,S] gate (bool) read once, the [K] corr and idx written."""
    S = P - T + 1
    nbytes = 4 * K * P * P + 4 * K * T * T + K * S * S + 8 * K
    return B * float(K * S * S * T * T), B * float(nbytes)


def frame_fma(K: int, B: int = 1) -> float:
    """FMAs of one filter frame's dense linear algebra at K slots (D = 13 +
    6K, 2K innovation rows), a lower bound of the frame's work: A = H P
    (each row of H touches 13 camera and 6 own columns), T = A H^T, the
    Cholesky of [2K,2K], the triangular solve for [2K, D+1], and the
    downdate. Recruitment, prediction and the search are left out."""
    D, n = 13 + 6 * K, 2 * K
    return B * (n * 19 * D + n * n * 19 + n ** 3 / 6 + n * n * (D + 1) / 2
                + D * (D + 1) / 2 * n)


def bound_s(fma: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the FMAs over
    the float32 rate and the bytes over the memory rate."""
    return max(fma / F32_FMA_PER_S, nbytes / HBM_BYTES_PER_S)
