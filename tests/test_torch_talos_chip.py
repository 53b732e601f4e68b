"""TALOS multi-contact on the card, and the polish chains' sub-stage
stamps inside the captured graphs. Each test needs an NVIDIA card and
skips without one; on the card, from the root of a checkout:

    python -m pytest tests/test_torch_talos_chip.py -m chip -s \\
        --noconftest -p no:cacheprovider

(``--noconftest``: the suite's conftest loads JAX, which the card's
machine does not have; this file imports neither JAX nor the JAX
package). The data is the benchmark's (`qpbench.gen`, the cells'
configurations and options, seed 625701960):

* a captured cold batch of 8192 TALOS steps (`talos-mc-cold`): a sample
  of its kSuccess answers against the plain reference, within
  `qpbench.check.LIMITS`; every polish chain on cuBLAS at N2 = 196;
* the cold batch of 8192 of each cold cell captured with the chain
  stamps and without any stamp: the same answers bit for bit, the same
  nodes but the stamps, and in every replay the chains' sub-stage time
  within the polish stage's.
"""

import contextlib
import os

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 625701960
# sampled answers read against the reference
SAMPLE = 512
pytestmark = pytest.mark.chip


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card with `python -m "
                    "pytest tests/test_torch_talos_chip.py -m chip "
                    "--noconftest`")
    torch.set_num_threads(1)
    return torch.device("cuda")


def _cold(name, dev):
    """The cell's problem shape, options and first cold batch (batch-last
    on the card)."""
    from qpbench import drivers, gen, spec

    cell = spec.cell(ROOT, name)
    B = int(cell.traffic["batch"])
    log = gen.walking_log(cell.config["model"], cell.config["generator"], B,
                          gen.generator(SEED, dev), dev)
    return (cell, drivers.problem_shape(cell), drivers.options(cell), log,
            drivers.batch_last(log))


def _bits(x):
    from fcc_qp_tpu_torch.ops.device_branch import _leaves

    return b"".join(a.detach().contiguous().cpu().numpy().tobytes()
                    for a in _leaves(x, []))


@contextlib.contextmanager
def _stamp_free(monkeypatch):
    """Captures made inside make no stamp of either row."""
    from fcc_qp_tpu_torch.core import graphs

    @contextlib.contextmanager
    def none(rec, graph):
        yield rec

    with monkeypatch.context() as m:
        m.setattr(graphs, "stamping", none)
        yield


def test_talos_cold_batch_against_the_reference(card):
    from fcc_qp_tpu_torch import solve_batched_ds
    from fcc_qp_tpu_torch.utils.timing import telemetry
    from qpbench import check, gen

    cell, shape, opts, log, qp = _cold("talos-mc-cold", card)
    torch.cuda.reset_peak_memory_stats(card)
    solve_batched_ds(qp, shape, opts, device=card)      # captures
    sol, _ = solve_batched_ds(qp, shape, opts, device=card)
    torch.cuda.synchronize(card)
    peak = torch.cuda.max_memory_allocated(card)
    d = sol.details
    ok = d.solve_status == 0
    fail = 1.0 - float(ok.double().mean())
    print(f"[talos] B = {ok.numel()}: not kSuccess {int((~ok).sum())} "
          f"({100 * fail:.4f}%), polish accepted "
          f"{100 * float(d.polish_accepted.double().mean()):.4f}%, mean "
          f"n_iter_ds {float(d.n_iter_ds.double().mean()):.2f}; peak memory "
          f"{peak} bytes ({torch.cuda.get_device_name(card)})")
    g = torch.Generator().manual_seed(SEED)
    rows = torch.nonzero(ok).flatten().cpu()
    rows = rows[torch.randperm(rows.numel(), generator=g)[:SAMPLE]]
    rows = torch.cat([rows, d.n_iter.argmax().cpu()[None]]).to(card)
    rows = rows[ok[rows]]
    dims = gen.dims(cell.config["model"])
    read = check.readings({k: v[rows] for k, v in log.items()}, sol.z[rows],
                          dims["ls"], dims["nc"])
    correct, compared = check.verdict(read)
    print(f"[talos] {read['n_read']} sampled: {compared}")
    assert correct, compared
    caps = [c for c in telemetry(card)["captures"]
            if c["kind"] == "batch" and not c["warm"]]
    sites = [s for s in caps[-1]["sites"] if s["name"] == "polish_chain"]
    assert sites and {(s["n2"], s["path"]) for s in sites} == {
        (196, "cublas")}


@pytest.mark.parametrize("name", ["cassie-cold", "humanoid-cold",
                                  "talos-mc-cold"])
def test_chain_stamps_leave_the_answers_bit_for_bit(card, monkeypatch,
                                                    name):
    from fcc_qp_tpu_torch.core.ds_engine import (constrained_indices,
                                                 reduced_stages)
    from fcc_qp_tpu_torch.core.graphs import CapturedBatch
    from fcc_qp_tpu_torch.ops import polish
    from fcc_qp_tpu_torch.utils.timing import STAGES

    _, shape, opts, _, qp = _cold(name, card)
    B = qp.batch
    stages = reduced_stages(shape, opts, constrained_indices(qp, shape))
    caps = []
    for stamped in (True, False):
        cap = CapturedBatch(stages, B, card)
        cap.load(qp)
        with (contextlib.nullcontext() if stamped
              else _stamp_free(monkeypatch)):
            cap.run(False)
        caps.append(cap)
    a, b = (c.records[False] for c in caps)
    assert _bits(caps[0].out) == _bits(caps[1].out)
    assert sum(b.stamps.values()) == 0 and not b.sites
    for g in ("operator", "iteration"):
        assert a.nodes[g]["kernel"] == b.nodes[g]["kernel"] + a.stamps[g]
    chains = [s for s in a.sites if s["name"] == "polish_chain"]
    assert chains and all(s["graph"] == "iteration" for s in chains)
    for s in chains:
        seed = "seed" if s["mode"] != "refresh" else "refresh"
        want = "kernel" if polish.ns_kernel_takes(s["chains"], s["n2"],
                                                  seed) else "cublas"
        assert s["path"] == want, s
    polish_slot = 1 + 2 * STAGES.index("polish")
    for rep in range(3):
        torch.cuda.synchronize(card)
        p0 = int(a.row[polish_slot].item())
        s0 = int(a.sub[1::2].sum().item())
        caps[0].run(False)
        torch.cuda.synchronize(card)
        polish_ms = (int(a.row[polish_slot].item()) - p0) * 1e-6
        chain_ms = (int(a.sub[1::2].sum().item()) - s0) * 1e-6
        visited = int(a.sub[2::2][:len(a.sites)].sum().item())
        print(f"[{name}] replay {rep}: polish {polish_ms:.6f} ms, its chains "
              f"{chain_ms:.6f} ms ({100 * chain_ms / polish_ms:.2f}%); "
              f"{len(chains)} chain sites, {visited} visits so far; stamps "
              f"{a.stamps}")
        assert 0 < chain_ms <= polish_ms
    assert _bits(caps[0].out) == _bits(caps[1].out)
