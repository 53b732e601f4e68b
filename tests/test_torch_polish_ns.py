"""The polish's Newton-Schulz chains (`ops.polish.polish_ns`) on the CPU:
the wrapper takes its plain version there and launches nothing, and the
plain version computes what the polish computed before the chains had a
kernel (`_seed_ref` and `_refresh_ref` below, kept as they were) bit for
bit, at Cassie's and the humanoid's KKT size (N2 = 102, 125). The kernel
itself is held against these chains on the card
(`tests/test_torch_polish_ns_chip.py`)."""

import numpy as np
import pytest
import torch

from fcc_qp_tpu_torch.ops import pallas_admm, polish
from fcc_qp_tpu_torch.utils.timing import StageClock

torch.set_num_threads(1)

# (n, m + ncones): Cassie (60 + 38 + 4 = 102), the humanoid (76 + 41 + 8)
SIZES = {102: (60, 42), 125: (76, 49)}


def _seed_ref(Mb, ns_iters: int = 40):
    N2 = Mb.shape[-1]
    fro2 = (Mb * Mb).sum(dim=(-1, -2))
    X = Mb.transpose(-1, -2) / torch.clamp_min(fro2, 1e-30)[:, None, None]
    eye2 = 2.0 * torch.eye(N2, dtype=Mb.dtype, device=Mb.device)
    for _ in range(ns_iters):
        X = X @ (eye2 - Mb @ X)
    return X


def _refresh_ref(X, Mb, steps: int):
    N2 = Mb.shape[-1]
    eye = torch.eye(N2, dtype=Mb.dtype, device=Mb.device)
    eye2 = 2.0 * eye

    def resid_inf(P):
        r = (P - eye).abs().sum(dim=-1).amax(dim=-1)
        return torch.where(torch.isfinite(r), r, torch.full_like(r, float("inf")))

    P = Mb @ X
    r_best = resid_inf(P)
    X_best = X
    for _ in range(steps):
        ok = (resid_inf(P) < 1.0)[:, None, None]
        X = torch.where(ok, X, X_best)
        P = torch.where(ok, P, Mb @ X_best)
        X = X @ (eye2 - P)
        P = Mb @ X
        r = resid_inf(P)
        better = r < r_best
        X_best = torch.where(better[:, None, None], X, X_best)
        r_best = torch.minimum(r, r_best)
    return X_best, r_best


def _kkt(N2, B, seed):
    """(B, N2, N2) f32 row-replaced pinned KKTs, as the polish assembles
    them (`polish._assemble_m2_masked`), from numpy data: SPD Q, random
    rows, about a tenth of the coordinates pinned, the surface rows'
    -diag(1 - surf) tail."""
    n, m2 = SIZES[N2]
    rng = np.random.default_rng(seed)
    G = rng.normal(size=(B, n, n))
    Q = G @ G.transpose(0, 2, 1) / n + np.eye(n)
    A = rng.normal(size=(B, m2, n))
    pin = (rng.random((B, n)) < 0.1).astype(np.float32)
    D = np.concatenate([np.zeros((B, m2 - N2 // 25)),
                        (rng.random((B, N2 // 25)) < 0.5)], axis=1)
    t = lambda a, perm: torch.from_numpy(
        np.ascontiguousarray(a.transpose(perm))).float()
    return polish._assemble_m2_masked(t(Q, (1, 2, 0)), t(pin, (1, 0)),
                                      t(A, (1, 2, 0)), t(D, (1, 0)))


def _carried(Mb, seed):
    """Carried seeds of a batch of six: the seeds of a KKT moved by about
    1e-3 (the refresh contracts), scaled by 2.5 (residual 1.5: the first
    step diverges and the second restarts from the best iterate), by -1 and
    by 1e3 (diverges), and one holding a NaN."""
    rng = np.random.default_rng(seed)
    moved = Mb * (1 + 1e-3 * torch.from_numpy(
        rng.normal(size=Mb.shape)).float())
    X = _seed_ref(moved)
    scale = torch.tensor([1.0, 1.0, 2.5, -1.0, 1e3, 1.0])[:, None, None]
    X = X * scale
    X[5, 3, 7] = float("nan")
    return X


def _equal(a, b):
    return torch.equal(torch.nan_to_num(a, nan=7.0),
                       torch.nan_to_num(b, nan=7.0)) and bool(
        (a.isnan() == b.isnan()).all())


@pytest.fixture
def no_launch():
    pallas_admm.reset_launch_counts()
    yield
    assert all(fn.launches == 0 for fn in pallas_admm.KERNELS)


@pytest.mark.parametrize("N2", sorted(SIZES))
def test_seed_plain_equals_the_batched_chain(N2, no_launch):
    Mb = _kkt(N2, 6, seed=N2)
    X = polish.polish_ns(Mb)
    assert torch.equal(X, _seed_ref(Mb))
    # the seeds invert the KKTs they were built for
    r = polish._ns_resid(Mb @ X)
    assert float(r.max()) < 1e-2


@pytest.mark.parametrize("N2", sorted(SIZES))
def test_refresh_plain_equals_the_guarded_chain(N2, no_launch):
    Mb = _kkt(N2, 6, seed=N2 + 1)
    X = _carried(Mb, seed=N2 + 2)
    X_in = X.clone()
    got, r_got = polish.polish_ns(Mb, X, 2)
    want, r_want = _refresh_ref(X, Mb, 2)
    assert _equal(got, want) and torch.equal(r_got, r_want)
    assert _equal(X, X_in) and got.data_ptr() != X.data_ptr()
    # the moved seeds contract; the restarted one keeps its carried seed
    assert float(r_got[:2].max()) < 0.3
    assert _equal(got[2], X_in[2]) and 1.0 <= float(r_got[2]) < 2.0
    assert float(r_got[4]) > 100 and torch.isinf(r_got[5])


@pytest.mark.parametrize("N2", sorted(SIZES))
def test_restart_only_where_the_iterate_is_not_the_best(N2, no_launch):
    """Restarting every instance whose residual is not below 1 (the
    batched chain) and only those whose iterate is not the best one (the
    kernel's rule) give the same iterates: where X is X_best, the restart
    product Mb X_best is the P in hand."""
    Mb = _kkt(N2, 6, seed=N2 + 3)
    X = _carried(Mb, seed=N2 + 4)
    for steps in (1, 2, 3):
        got, r_got = polish.polish_ns_plain(Mb, X, steps)
        want, r_want = _refresh_ref(X, Mb, steps)
        assert _equal(got, want) and torch.equal(r_got, r_want), steps


@pytest.mark.parametrize("N2", sorted(SIZES))
def test_masked_rebuild_writes_kept_slots_only(N2, no_launch):
    B = 8
    M = _kkt(N2, B, seed=N2 + 5)
    rng = np.random.default_rng(N2)
    out = torch.from_numpy(rng.normal(size=M.shape)).float()
    before = out.clone()
    idx = torch.from_numpy(rng.permutation(B)[:5])
    keep = torch.tensor([True, False, True, True, False])
    stats = {}
    clock = StageClock(stats, torch.device("cpu"))
    got = polish.polish_ns(M[idx], out=out, idx=idx, keep=keep, clock=clock)
    assert got is out
    seeds = _seed_ref(M[idx])
    for j in range(5):
        assert torch.equal(out[idx[j]], seeds[j] if keep[j] else before[idx[j]])
    untouched = sorted(set(range(B)) - set(idx.tolist()))
    assert torch.equal(out[untouched], before[untouched])
    # the counts are of the kernel's chains: the plain version counts none
    assert stats == {}


@pytest.mark.parametrize("B, N2, mode, takes", [
    (1, 102, "seed", False), (1, 102, "refresh", True),
    (polish.NS_KERNEL_MIN_BATCH["seed"] - 1, 125, "seed", False),
    (polish.NS_KERNEL_MIN_BATCH["seed"], 102, "seed", True),
    (8192, 125, "seed", True), (8192, 128, "refresh", True),
    (8192, 129, "seed", False), (1, 129, "refresh", False)])
def test_which_batches_the_kernel_takes(B, N2, mode, takes):
    assert polish.ns_kernel_takes(B, N2, mode) == takes
