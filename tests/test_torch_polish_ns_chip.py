"""The polish's Newton-Schulz kernel (`ops.polish.polish_ns`,
`csrc/polish_ns.cu`) on the card, against the batched cuBLAS chain it
replaces (`ops.polish.polish_ns_plain` on CUDA tensors). Each test needs
an NVIDIA card and skips without one; on the card, from the root of a
checkout:

    python -m pytest tests/test_torch_polish_ns_chip.py -m chip -s \\
        --noconftest -p no:cacheprovider

(``--noconftest``: the suite's conftest loads JAX, which the card's
machine does not have; this file imports neither). The data is the
benchmark's (`qpbench.gen`, the cells' configurations and options, seed
625701960):

* the chains' inputs of an eager cold solve of 8192 of each
  configuration (N2 = 102 and 125): the first seed's KKTs and the
  largest refresh's seeds and KKTs, cut to B = 8192, 1024, 128 and 1;
  the kernel (at every B, B = 1 included) against the chain at 8192,
  where cuBLAS sums each product in ascending k as the kernel does: the
  seeds (from the full batch's norms, a reduction whose order can change
  with the batch) and the refreshed X_best hold the chain's values, the
  refresh's residuals agree to their sums' rounding
  (`chip_smoke.ns_resid_close`) and give the same rebuilds (residual >
  0.3); the wrapper's seeds at B >= 128 hold them too; below 128, where
  cuBLAS splits k, the kernel's residuals at most twice the chain's at
  that batch (plus 1e-6);
* a masked rebuild pass: the slots it skips and the slots it does not
  name stay as they were, bit for bit, the kept slots hold the chain's
  values, and an eager clock counts the chains computed and skipped;
* a captured cold batch of 8192 of each configuration and one captured
  replay call (4096 x 16): the polish accepts as many instances with the
  kernel as with the chain.
"""

import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 625701960
pytestmark = pytest.mark.chip


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card with `python -m "
                    "pytest tests/test_torch_polish_ns_chip.py -m chip "
                    "--noconftest`")
    torch.set_num_threads(1)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    return torch.device("cuda")


def _cell(name):
    from qpbench import drivers, spec

    cell = spec.cell(ROOT, name)
    return cell, drivers.problem_shape(cell), drivers.options(cell)


def _batch(cell, B, dev):
    from qpbench import gen
    from qpbench.drivers import batch_last

    return batch_last(gen.walking_log(
        cell.config["model"], cell.config["generator"], B,
        gen.generator(SEED, dev), dev))


_INPUTS = {}


def _inputs(name, dev):
    """The chains' inputs of an eager cold solve of 8192 (kept per
    configuration for the module)."""
    if name not in _INPUTS:
        import chip_smoke as cs
        from fcc_qp_tpu_torch import solve_batched_ds

        cell, shape, opts = _cell(name)
        qp = _batch(cell, 8192, dev)
        _INPUTS[name] = cs.ns_chain_inputs(
            lambda: solve_batched_ds(qp, shape, opts, graphs=False))
    return _INPUTS[name]


def _report(tag, got, want, Mb):
    """Prints the comparison; returns whether the values are equal and the
    residuals ||Mb X - I||_inf of both sides (B,)."""
    import chip_smoke as cs
    from fcc_qp_tpu_torch.ops import polish

    same = cs.bits_equal(got, want)
    values = same or cs.values_equal(got, want)
    gap = 0 if same else cs.ulp_gap(got, want)
    rk, rp = polish._ns_resid(Mb @ got), polish._ns_resid(Mb @ want)
    print(f"[{tag}] B={Mb.shape[0]} N2={Mb.shape[-1]}: "
          + ("bit for bit" if same else
             f"equal values: {values}, largest ulp gap {gap}")
          + f"; residual max kernel {float(rk.max()):.6e}, chain "
          f"{float(rp.max()):.6e}")
    return values, rk, rp


# at and above this batch cuBLAS sums each product in ascending k (no
# split-K), as the kernel does
NO_SPLIT_K = 128


def _seed_launch(Mb, den):
    """The kernel's seeds of ``Mb`` from the given ``den`` (B,), one
    launch of the library as `polish.polish_ns` makes it."""
    import ctypes

    from fcc_qp_tpu_torch.ops import polish

    out = torch.empty_like(Mb)
    B, N2 = Mb.shape[0], Mb.shape[-1]
    err = polish.build_polish_ns().polish_ns(
        Mb.data_ptr(), den.contiguous().data_ptr(), None, out.data_ptr(),
        None, None, None, B, N2, polish.NS_SEED_ITERS, 0,
        ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    assert err == 0
    return out


@pytest.mark.parametrize("name", ["cassie-cold", "humanoid-cold"])
@pytest.mark.parametrize("B", [8192, 1024, 128, 1])
def test_kernel_against_the_cublas_chain(card, monkeypatch, name, B):
    import chip_smoke as cs
    from fcc_qp_tpu_torch.ops import polish

    ins = _inputs(name, card)
    M8 = ins["seed"]
    X, Mr = ins["refresh"]
    reps = -(-M8.shape[0] // Mr.shape[0])
    X8 = X.repeat(reps, 1, 1)[:M8.shape[0]].contiguous()
    Mr8 = Mr.repeat(reps, 1, 1)[:M8.shape[0]].contiguous()
    N2 = M8.shape[-1]
    Mb, X, Mr = (t[:B].contiguous() for t in (M8, X8, Mr8))
    monkeypatch.setattr(polish, "NS_KERNEL_MIN_BATCH",
                        {"seed": 1, "refresh": 1})
    before = polish.polish_ns.launches
    got, (xk, rk) = polish.polish_ns(Mb), polish.polish_ns(Mr, X)
    assert polish.polish_ns.launches == before + 2
    # the chain where it sums as the kernel does: at the full batch
    want = polish.polish_ns_plain(M8)[:B]
    xp, rp = (t[:B] for t in polish.polish_ns_plain(Mr8, X8))
    # a seed starts from Mb' / ||Mb||_F^2, a torch reduction whose order
    # can change with the batch: from the full batch's norms the kernel's
    # chains at B are the full batch's chain's
    den8 = torch.clamp_min((M8 * M8).sum(dim=(-1, -2)), 1e-30)
    seed_eq, _, _ = _report(f"{name} seed, the full batch's norms",
                            _seed_launch(Mb, den8[:B]), want, Mb)
    wrapper_eq, _, _ = _report(f"{name} seed", got, want, Mb)
    refresh_eq, _, _ = _report(f"{name} refresh", xk, xp, Mr)
    r_close, r_gap = cs.ns_resid_close(rk, rp, N2)
    print(f"[{name} refresh] rebuilds (residual > 0.3): kernel "
          f"{int((rk > 0.3).sum())}, chain {int((rp > 0.3).sum())}; r_best "
          f"largest ulp gap {r_gap}")
    assert seed_eq and refresh_eq
    assert r_close
    assert torch.equal(rk > 0.3, rp > 0.3)
    if B >= NO_SPLIT_K:
        assert wrapper_eq
    else:
        # the chain at this batch splits k: its own residuals bound the
        # kernel's
        _, sk, sp = _report(f"{name} seed, chain at B={B}", got,
                            polish.polish_ns_plain(Mb), Mb)
        xq, rq = polish.polish_ns_plain(Mr, X)
        _report(f"{name} refresh, chain at B={B}", xk, xq, Mr)
        assert bool((sk <= 2 * sp + 1e-6).all())
        assert bool((rk <= 2 * rq + 1e-6).all())


@pytest.mark.parametrize("name", ["cassie-cold", "humanoid-cold"])
def test_masked_pass_leaves_skipped_slots(card, name):
    import chip_smoke as cs
    from fcc_qp_tpu_torch.ops import polish
    from fcc_qp_tpu_torch.utils.timing import StageClock

    Mb = _inputs(name, card)["seed"]
    B, C = Mb.shape[0], 1024
    g = torch.Generator(device=card).manual_seed(SEED)
    idx = torch.randperm(B, device=card, generator=g)[:C]
    keep = torch.rand(C, device=card, generator=g) < 0.5
    base = torch.randn(Mb.shape, device=card, generator=g)
    stats = {}
    got = polish.polish_ns(Mb[idx], out=base.clone(), idx=idx, keep=keep,
                           clock=StageClock(stats, card))
    want = polish.polish_ns_plain(Mb[idx], out=base.clone(), idx=idx,
                                  keep=keep)
    untouched = torch.ones(B, dtype=torch.bool, device=card)
    untouched[idx[keep]] = False
    assert cs.bits_equal(got[untouched], base[untouched])
    kept_eq, _, _ = _report(f"{name} masked pass of {C}", got[idx[keep]],
                            want[idx[keep]], Mb[idx[keep]])
    assert kept_eq
    print(f"[{name} masked pass of {C}] clock {stats}")
    assert stats == {"n_polish_ns_live": int(keep.sum()),
                     "n_polish_ns_skipped": C - int(keep.sum())}


def _chain_everywhere(monkeypatch):
    from fcc_qp_tpu_torch.ops import polish

    monkeypatch.setattr(polish, "NS_KERNEL_MIN_BATCH",
                        {"seed": 1 << 40, "refresh": 1 << 40})


@pytest.mark.parametrize("name", ["cassie-cold", "humanoid-cold"])
def test_captured_cold_batch_accepts_as_the_chain(card, monkeypatch, name):
    from fcc_qp_tpu_torch.core.ds_engine import (constrained_indices,
                                                 reduced_stages)
    from fcc_qp_tpu_torch.core.graphs import CapturedBatch

    cell, shape, opts = _cell(name)
    qp = _batch(cell, 8192, card)
    stages = reduced_stages(shape, opts, constrained_indices(qp, shape))
    accepted = []
    for chain in (False, True):
        with monkeypatch.context() as m:
            if chain:
                _chain_everywhere(m)
            cap = CapturedBatch(stages, 8192, card)
            cap.load(qp)
            cap.run(False)
            rec = cap.records[False]
            d = cap.out.details
            accepted.append(int(d.polish_accepted.sum()))
            print(f"[{name}] {'chain' if chain else 'kernel'}: polish "
                  f"accepted {accepted[-1]}, kSuccess "
                  f"{int((d.solve_status == 0).sum())}, polish_ns launches "
                  f"under capture {rec.launches.get('polish_ns')}, kernel "
                  f"nodes {rec.nodes}")
            assert (rec.launches["polish_ns"] > 0) != chain
    assert accepted[0] == accepted[1]


def test_replay_call_accepts_as_the_chain(card, monkeypatch):
    import chip_smoke as cs
    from fcc_qp_tpu_torch.core.ds_engine import (QPBatchDS,
                                                 constrained_indices,
                                                 reduced_stages)
    from fcc_qp_tpu_torch.core.graphs import replay_captured

    cell, shape, opts = _cell("cassie-replay")
    S, steps = int(cell.traffic["streams"]), int(cell.traffic["steps"])
    qps = _batch(cell, S * steps, card)
    stages = reduced_stages(shape, opts, constrained_indices(qps, shape),
                            cached=True)
    log = QPBatchDS(*(a.reshape(*a.shape[:-1], S, steps).movedim(-1, 0)
                      .contiguous() for a in qps))
    accepted = []
    for chain in (False, True):
        with monkeypatch.context() as m:
            if chain:
                _chain_everywhere(m)
            cs.drop_captures()    # each path captures anew
            sols, _, _, _ = replay_captured(stages, log, card)
            per_step = [int(s.details.polish_accepted.sum()) for s in sols]
            accepted.append(per_step)
            print(f"[replay] {'chain' if chain else 'kernel'}: polish "
                  f"accepted per step {per_step}")
    assert accepted[0] == accepted[1]
