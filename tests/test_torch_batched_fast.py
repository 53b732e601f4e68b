"""Parity of the port's batch-level engine (`fcc_qp_tpu_torch.
solve_batched_fast`) with the JAX package's, on the CPU, at the options
and shapes of `tests/test_batched_fast.py` (so the JAX programs that file
compiles serve these tests too), with over-relaxation (alpha = 1.6) and
adaptive rho.

The port runs its chunks through the full-layout kernel's plain version
(the wrapper's choice for CPU tensors) with the adaptation between
chunks; the JAX package runs its batched `while_loop`. Bars: status and
n_iter equal per instance, and |dz| <= 1e-7 x (1 + max|z|) per instance.
That bar is set by the operator build, not by the engine: the port's and
the JAX package's f64 KKT inverses of this raw walking-log data differ by
about 7e-14 relative, which 300 unconverged iterations carry to about
2.5e-8 relative in z; the port's engine at alpha = 1 without adaptation
equals its own parity engine bit for bit (as the JAX package's two
engines equal each other), and so is held exactly there."""

import numpy as np
import pytest
import torch

import fcc_qp_tpu_torch as T
from fcc_qp_tpu import solve_batched_fast as jfast
from fcc_qp_tpu.models.osc import (CASSIE, QUADRUPED, generate_osc_batch,
                                   generate_osc_sequence)
from fcc_qp_tpu.utils.io import stack_qp_dicts, to_qpbatch
from test_batched_fast import OPTS

torch.set_num_threads(1)

TOPTS = T.FCCQPOptions(max_iter=OPTS.max_iter, rho=OPTS.rho,
                       eps_fcone=OPTS.eps_fcone, eps_bound=OPTS.eps_bound)
ADAPT = dict(max_iter=2000, adaptive_rho=True, adaptive_rho_interval=50)


def _tshape(model):
    s = model.shape
    return T.ProblemShape(s.num_vars, s.num_eq, s.nc, s.lambda_c_start)


def _both(stacked, model, kw, jwarm=None, twarm=None):
    ws = dict(warm=jwarm, warm_start=True) if jwarm is not None else {}
    jsol, jws = jfast(to_qpbatch(stacked), model.shape, OPTS.replace(**kw),
                      **ws)
    stages = {}
    tws = dict(warm=twarm, warm_start=True) if twarm is not None else {}
    tsol, tw = T.solve_batched_fast(
        T.QPBatch(**{k: torch.from_numpy(v) for k, v in stacked.items()}),
        _tshape(model), TOPTS.replace(**kw), device="cpu",
        stage_times=stages, **tws)
    return jsol, jws, tsol, tw, stages


def _hold(jsol, tsol, dz):
    np.testing.assert_array_equal(tsol.details.solve_status.numpy(),
                                  np.asarray(jsol.details.solve_status))
    np.testing.assert_array_equal(tsol.details.n_iter.numpy(),
                                  np.asarray(jsol.details.n_iter))
    jz, tz = np.asarray(jsol.z), tsol.z.numpy()
    rel = np.abs(tz - jz).max(axis=1) / (1.0 + np.abs(jz).max(axis=1))
    assert rel.max() <= dz


@pytest.fixture(scope="module")
def cassie24():
    return stack_qp_dicts(generate_osc_sequence(CASSIE, 24, seed=0))


# at rho = 0.1 over-relaxation and one rho adaptation both act, and every
# instance converges (at rho = 1 and alpha = 1.6 no rho adapts and most
# instances run to the cap, in both packages)
@pytest.mark.parametrize("case,kw", [
    ("reference", {}),
    ("adaptive", ADAPT),
    ("alpha_adaptive", dict(ADAPT, alpha=1.6, rho=0.1)),
])
def test_matches_jax(cassie24, case, kw):
    jsol, _, tsol, _, stages = _both(cassie24, CASSIE, kw)
    _hold(jsol, tsol, 1e-7)
    if kw.get("adaptive_rho"):
        assert stages["n_refactor"] >= 1
        assert (tsol.details.solve_status.numpy() == 0).all()


def test_reference_options_equal_the_parity_engine(cassie24):
    """alpha = 1 without adaptation: the parity engine's iteration."""
    qp = T.QPBatch(**{k: torch.from_numpy(v) for k, v in cassie24.items()})
    fast, fw = T.solve_batched_fast(qp, _tshape(CASSIE), TOPTS, device="cpu")
    ref, rw = T.solve_batched(qp, _tshape(CASSIE), TOPTS, device="cpu")
    assert torch.equal(fast.z, ref.z)
    assert torch.equal(fast.details.n_iter, ref.details.n_iter)
    assert torch.equal(fw.mu_x, rw.mu_x)


def test_warm_start_matches_jax(cassie24):
    jsol, jws, tsol, tws, _ = _both(cassie24, CASSIE, {})
    jsol2, _, tsol2, _, _ = _both(
        cassie24, CASSIE, {}, jwarm=jws,
        twarm=T.WarmStart(tws.x, tws.mu_x, tws.mu_lambda_c))
    _hold(jsol2, tsol2, 1e-7)


def test_quadruped_adaptive_matches_jax():
    st = stack_qp_dicts(generate_osc_batch(QUADRUPED, 8, seed=5))
    jsol, _, tsol, _, _ = _both(st, QUADRUPED, dict(max_iter=2000,
                                                    adaptive_rho=True))
    _hold(jsol, tsol, 1e-7)
    assert (tsol.details.solve_status.numpy() == 0).mean() >= 0.7


def test_equality_constrained_instances():
    rng = np.random.default_rng(0)
    B, n, m = 3, 12, 4
    G = rng.normal(size=(B, n, n))
    st = dict(Q=np.einsum("bij,bkj->bik", G, G) + np.eye(n),
              b=rng.normal(size=(B, n)), A_eq=rng.normal(size=(B, m, n)),
              b_eq=rng.normal(size=(B, m)), friction_coeffs=np.zeros((B, 0)),
              lb=np.full((B, n), -np.inf), ub=np.full((B, n), np.inf))
    sol, _ = T.solve_batched_fast(
        T.QPBatch(**{k: torch.from_numpy(v) for k, v in st.items()}),
        T.ProblemShape(n, m, 0, 0), TOPTS, device="cpu")
    assert (sol.details.n_iter.numpy() == 0).all()
    r = np.einsum("bij,bj->bi", st["A_eq"], sol.z.numpy()) - st["b_eq"]
    assert np.abs(r).max() < 1e-8
