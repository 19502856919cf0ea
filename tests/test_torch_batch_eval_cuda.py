"""Batched evaluation on the card: kernel B2's batched entry points against
the plain version and against the unbatched kernel, and the batched scan
runner and batch BA in float64 on the card against the CPU. Imports no JAX,
so it runs where the card is:

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_batch_eval_cuda.py -m cuda -q

Without a CUDA device every case skips (the kernel has no CPU mode)."""

import numpy as np
import pytest
import torch

from surikatoko_tpu_torch.ops import covariance
from surikatoko_tpu_torch.utils.profiling import counts


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from surikatoko_tpu_torch import config
    config.set_full_precision()
    return torch.device("cuda", 0)


def _batch(B, D, m, dev, dtype):
    g = torch.Generator(device=dev).manual_seed(B * 1000 + D * 7 + m)
    A = torch.randn(B, D, D, generator=g, device=dev, dtype=dtype)
    P = A @ A.mT / D
    P = torch.tril(P) + torch.tril(P, -1).mT
    M = 0.05 * torch.randn(B, m, D, generator=g, device=dev, dtype=dtype)
    keep = (torch.rand(B, D, generator=g, device=dev, dtype=dtype)
            > 0.05).to(dtype)
    return P, M, keep


def _within(got, want, P, M, keep):
    """The kernel phase's tolerances: float32 |diff| <= 1e-5 (|P| o |kk^T| +
    |M o k|^T |M o k|) + 1e-30; float64 within 1e-12 in the relative
    Frobenius norm, problem by problem."""
    if got.dtype == torch.float64:
        return all(float(torch.linalg.norm(g - w) / torch.linalg.norm(w))
                   <= 1e-12 for g, w in zip(got, want))
    k = torch.ones_like(P[..., 0]) if keep is None else keep
    Mk = (M * k[..., None, :]).abs()
    bound = 1e-5 * (P.abs() * (k[..., :, None] * k[..., None, :])
                    + Mk.mT @ Mk) + 1e-30
    return bool(((got - want).abs() <= bound).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B,D,m", [(32, 589, 192), (6, 109, 32), (3, 130, 7),
                                   (1, 43, 10), (2, 2317, 48)])
@pytest.mark.parametrize("with_keep", [False, True])
def test_torch_batched_downdate_kernel_matches_plain_and_unbatched(
        dtype, B, D, m, with_keep):
    """One launch for the batch, within tolerance of the plain version,
    bitwise symmetric, each slice bit for bit its unbatched kernel call
    (32-wide and, at D = 2317, 128-wide float32 tiles with the padded
    copy; the DMMA kernel in float64)."""
    dev = _card()
    P, M, keep = _batch(B, D, m, dev, dtype)
    keep = keep if with_keep else None
    before = counts().get("b2.calls", 0)
    got = covariance.symmetric_downdate(P, M, keep)
    torch.cuda.synchronize()
    assert counts().get("b2.calls", 0) == before + 1
    assert got.shape == (B, D, D) and got.dtype == dtype
    assert torch.equal(got, got.mT) and bool(torch.isfinite(got).all())
    assert _within(got, covariance.symmetric_downdate_ref(P, M, keep), P, M,
                   keep)
    for b in range(B):
        one = covariance.symmetric_downdate(P[b], M[b],
                                            None if keep is None else keep[b])
        assert torch.equal(got[b], one)
    assert torch.equal(got, covariance.symmetric_downdate(P, M, keep))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("D", [589, 2317])
def test_torch_batched_downdate_kernel_under_vmap(dtype, D):
    """torch.func.vmap reaches the batched kernel through the operator's
    rule: one launch, equal to the direct batched call; a P and keep shared
    by every problem (vmap's unbatched arguments, passed with stride 0) and
    a shared M (padded once for 128-wide tiles) equal the unbatched calls."""
    dev = _card()
    B, m = 4, 64
    P, M, keep = _batch(B, D, m, dev, dtype)
    vmap = torch.func.vmap
    before = counts().get("b2.calls", 0)
    got = vmap(covariance.symmetric_downdate)(P, M, keep)
    torch.cuda.synchronize()
    assert counts().get("b2.calls", 0) == before + 1
    assert torch.equal(got, covariance.symmetric_downdate(P, M, keep))
    shared = vmap(covariance.symmetric_downdate, in_dims=(None, 0, None))(
        P[0], M, keep[0])
    shared_m = vmap(covariance.symmetric_downdate, in_dims=(0, None, 0))(
        P, M[0], keep)
    for b in range(B):
        assert torch.equal(shared[b],
                           covariance.symmetric_downdate(P[0], M[b], keep[0]))
        assert torch.equal(shared_m[b],
                           covariance.symmetric_downdate(P[b], M[0], keep[b]))


# (B, D, m, form): both sides of each edge in B of the float32 rule (132
# SMs) at D = 589 (Small32 | Tile32 | Batch32), 301 (Small16 | Small32 |
# Tile32 | Batch32), 864 (Small32 | Tile32) and 1000 (Tile32 | Batch32):
# the batch's form differs from its problems' own
B_EDGES = [(2, 589, 48, "Small32"), (3, 589, 48, "Tile32"),
           (5, 589, 24, "Tile32"), (6, 589, 24, "Batch32"),
           (2, 301, 33, "Small32"), (7, 301, 33, "Small32"),
           (8, 301, 33, "Tile32"), (19, 301, 17, "Tile32"),
           (20, 301, 17, "Batch32"), (2, 1000, 24, "Batch32"),
           (7, 1000, 24, "Batch32"), (2, 864, 24, "Tile32")]


@pytest.mark.cuda
@pytest.mark.parametrize("B,D,m,form", B_EDGES)
def test_torch_batched_downdate_equals_unbatched_across_the_batch_rule(
        B, D, m, form):
    """A batch whose size puts it in another float32 form than its
    problems alone (one problem of D <= 864 takes Small16 or Small32, of
    D = 1000 Tile32)
    still equals, slice by slice, the unbatched calls bit for bit, and
    vmap equals the batched call."""
    dev = _card()
    if covariance.sm_count(dev) == covariance.H100_SMS:
        assert covariance.F32_FORMS[covariance.f32_form(D, B)].name == form
    P, M, keep = _batch(B, D, m, dev, torch.float32)
    got = covariance.symmetric_downdate(P, M, keep)
    vmapped = torch.func.vmap(covariance.symmetric_downdate)(P, M, keep)
    torch.cuda.synchronize()
    assert torch.equal(vmapped, got)
    for b in range(B):
        assert torch.equal(got[b], covariance.symmetric_downdate(
            P[b], M[b], keep[b]))


@pytest.mark.cuda
def test_torch_batched_downdate_kernel_rejects_what_it_cannot_take():
    dev = _card()
    P, M, keep = _batch(2, 64, 8, dev, torch.float32)
    with pytest.raises(ValueError):
        covariance.symmetric_downdate(P, M[:, :, :-1])              # width
    with pytest.raises(ValueError):
        covariance.symmetric_downdate(P, M[:1].expand(3, 8, 64))     # batch
    with pytest.raises(ValueError):
        covariance.symmetric_downdate(P, M, keep[:, :-1])            # keep
    with pytest.raises(ValueError):
        covariance.symmetric_downdate(P.double(), M)                 # mixed


def _scenario03(dev, dtype):
    from surikatoko_tpu_torch.geom import camera
    from surikatoko_tpu_torch.models.monoslam import init_state, make_params
    from surikatoko_tpu_torch.world.device_runner import (
        build_oscillating_scenario, init_with_gt_landmarks)
    rng = np.random.default_rng(3)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)  # noqa: E731
    cam = camera.make_intrinsics((320, 240), (160.0, 120.0), 1.95,
                                 (0.01, 0.01), dtype=dtype, device=dev)
    params = make_params(cam, None, dt=1.0, process_noise_lin_veloc_std=0.075,
                         process_noise_ang_veloc_std=0.01, dtype=dtype,
                         device=dev)
    sc = build_oscillating_scenario(96, dtype=dtype, device=dev)
    st = init_with_gt_landmarks(params, sc, init_state(96, dtype=dtype,
                                                       device=dev),
                                t(rng.standard_normal((96, 2))))
    return params, sc, st, t(rng.standard_normal((4, 30, 96, 2)))


@pytest.mark.cuda
def test_torch_batched_scan_runner_f64_on_card_matches_cpu():
    """make_batched_scan_runner(1), 4 noise seeds of scenario03 (K=96) over
    30 frames in float64 on the card, against each seed's unbatched run on
    the CPU: camera positions within 1e-9, one batched B2 launch a frame."""
    from surikatoko_tpu_torch.world.device_runner import (
        make_batched_scan_runner, make_scan_runner)
    dev = _card()
    params, sc, st, noise = _scenario03(dev, torch.float64)
    before = counts().get("b2.calls", 0)
    out = make_batched_scan_runner(params, 1)(st, sc, range(1, 31), noise)
    torch.cuda.synchronize()
    assert counts().get("b2.calls", 0) == before + 30
    assert torch.equal(out[0].P, out[0].P.mT) and not out[4].any()
    cpu = _scenario03(torch.device("cpu"), torch.float64)
    run = make_scan_runner(cpu[0], 1)
    want = torch.stack([run(cpu[2], cpu[1], range(1, 31), cpu[3][b])[3]
                        for b in range(4)])
    assert float((out[3].cpu() - want).abs().max()) <= 1e-9


@pytest.mark.cuda
def test_torch_batch_ba_f64_on_card_takes_each_problems_own_path():
    """demos.batch_ba's problems (B = 8, float64): the batch on the card
    takes each problem's stop code, iterations and trials of its own run on
    the card and on the CPU, and lands within 1e-9 of the CPU's batch."""
    from surikatoko_tpu_torch.demos import batch_ba
    from surikatoko_tpu_torch.interop import stack
    from surikatoko_tpu_torch.models.ba import BundleAdjustment, TermCriteria
    _card()
    term = TermCriteria(allowed_reproj_err_rel_change=1e-12, max_iters=25)
    res = {}
    for dev in ("cuda", "cpu"):
        probs = batch_ba.problems(batch_ba.make_args(batch=8, device=dev))
        ba = BundleAdjustment(device_loop=True)
        p, code, iters, err, trials = ba.compute_batched(stack(probs), term)[:5]
        alone = []
        for q in probs:
            ba.compute_inplace(q, term)
            alone.append((ba.stop_reason, ba.iterations, ba.trials))
        res[dev] = (p, [(batch_ba.STOP_REASON_STR[int(c)], int(i), int(t))
                        for c, i, t in zip(code, iters, trials)], alone)
    assert res["cuda"][1] == res["cuda"][2] == res["cpu"][1] == res["cpu"][2]
    for name in ("points", "cfw_R", "cfw_t"):
        diff = (getattr(res["cuda"][0], name).cpu()
                - getattr(res["cpu"][0], name)).abs().max()
        assert float(diff) <= 1e-9
