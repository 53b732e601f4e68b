"""Parity of the port's f64 KKT factorization (`fcc_qp_tpu_torch.ops.kkt`)
and its refined presolve solve (`ops.ds_linalg.kkt_solve_refined_ds`)
with the JAX package's, on the CPU: the same batches through both.

F, G and x_const agree to 1e-10 relative (to the largest entry of each
block) on Cassie data and random QPs: both sides are Cholesky-Schur
chains in f64 through different LAPACK builds, so they differ by
rounding amplified by the KKT's conditioning. On the rank-deficient
batch of `tests/test_rank_deficient.py` the shifted factors take the
Richardson rescue: F agrees to 1e-8, while G (on consistent right-hand
sides: with duplicated rows it is not unique) and x_const sit ~1e-7 from
the pseudoinverse's in both packages, and are held to it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fcc_qp_tpu.core.ds_engine import _split64
from fcc_qp_tpu.models.osc import CASSIE, generate_osc_sequence
from fcc_qp_tpu.ops import ds
from fcc_qp_tpu.ops import kkt as jkkt
from fcc_qp_tpu.ops.ds_linalg import kkt_solve_refined_ds as jrefined
from fcc_qp_tpu.utils.io import stack_qp_dicts
from fcc_qp_tpu_torch.ops import kkt as tkkt
from fcc_qp_tpu_torch.ops.ds_linalg import kkt_solve_refined_ds
from test_rank_deficient import _rank_deficient_batch
from test_solver import SHAPE, random_qp

torch.set_num_threads(1)

RHO = 1.0


def _batch(name):
    if name == "cassie":
        return stack_qp_dicts(generate_osc_sequence(CASSIE, 8, seed=0))
    if name == "rank_deficient":
        return _rank_deficient_batch()
    rng = np.random.default_rng(3)
    ds_ = [random_qp(rng, SHAPE, bound=2.0) for _ in range(8)]
    return {k: np.stack([d[k] for d in ds_]) for k in ds_[0]}


@jax.jit
def _jax_operator(Q, b, A, b_eq):
    F, G = jax.vmap(lambda q, a: jkkt.kkt_factor_blocks(q, a, RHO))(Q, A)
    _, xc = jax.vmap(
        lambda q, b_, a, e: jkkt.admm_operator(q, b_, a, e, RHO)
    )(Q, b, A, b_eq)
    return F, G, xc


def _rel(a, b):
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("name,tol", [
    ("cassie", 1e-10), ("random", 1e-10), ("rank_deficient", 1e-8),
])
def test_operator_blocks_match_jax(name, tol):
    st = _batch(name)
    F, G, xc = (np.asarray(a) for a in _jax_operator(
        st["Q"], st["b"], st["A_eq"], st["b_eq"]))
    t = {k: torch.from_numpy(v) for k, v in st.items()}
    tF, tG = tkkt.kkt_factor_blocks(t["Q"], t["A_eq"], RHO)
    _, txc = tkkt.admm_operator(t["Q"], t["b"], t["A_eq"], t["b_eq"], RHO)
    assert _rel(tF.numpy(), F) < tol
    if name != "rank_deficient":
        assert _rel(tG.numpy(), G) < tol
        assert _rel(txc.numpy(), xc) < tol
    else:
        # with duplicated rows the equality dual, and with it G, is not
        # unique: compare G on consistent right-hand sides, G A_eq. The
        # four Richardson steps from a shifted factor leave G A_eq and
        # x_const ~1e-7 relative from the pseudoinverse's in BOTH
        # packages (ROADMAP.md queue C), so they are held to it at 1e-6
        # and to each other at 2e-6; F agrees to 1e-8.
        A = st["A_eq"]
        assert _rel(tG.numpy() @ A, G @ A) < 2e-6
        assert _rel(txc.numpy(), xc) < 2e-6
        n = A.shape[-1]
        for i in range(len(A)):
            M = np.block([[st["Q"][i] + RHO * np.eye(n), A[i].T],
                          [A[i], np.zeros((A.shape[1], A.shape[1]))]])
            P = np.linalg.pinv(M)
            x_true = -P[:n, :n] @ st["b"][i] + P[:n, n:] @ st["b_eq"][i]
            assert _rel(txc.numpy()[i], x_true) < 1e-6
            assert _rel(tG.numpy()[i] @ A[i], P[:n, n:] @ A[i]) < 1e-6
        # the Schur complement of duplicated rows is singular: every
        # instance takes a shift and the refinement rescue
        H = t["Q"] + RHO * torch.eye(t["Q"].shape[-1], dtype=torch.float64)
        W = torch.linalg.solve(H, t["A_eq"].transpose(1, 2))
        _, shifted = tkkt._chol_or_regularized(t["A_eq"] @ W,
                                               return_shifted=True)
        assert shifted.all()


@pytest.mark.parametrize("name", ["cassie", "random"])
def test_presolve_matches_jax(name):
    """The unregularized equality-QP solve (rho = 0) of the presolve."""
    st = _batch(name)
    x = np.asarray(jax.jit(jax.vmap(
        lambda q, a, r, s: jkkt.kkt_solve(q, a, jnp.zeros(()), r, s)
    ))(st["Q"], st["A_eq"], -st["b"], st["b_eq"]))
    t = {k: torch.from_numpy(v) for k, v in st.items()}
    tx = tkkt.kkt_solve(t["Q"], t["A_eq"], 0.0, -t["b"], t["b_eq"])
    # rho = 0: the raw Schur route carries kappa(S) * eps, ~1e-8 relative
    # on Cassie's unequilibrated data, in both packages
    assert _rel(tx.numpy(), x) < (1e-7 if name == "cassie" else 1e-10)
    eq = np.einsum("bmn,bn->bm", st["A_eq"], tx.numpy()) - st["b_eq"]
    assert np.abs(eq).max() < 1e-8 * (1 + np.abs(st["b_eq"]).max())


def test_refined_presolve_matches_jax_ds():
    """`kkt_solve_refined_ds` (the exact presolve of the batched engines):
    native f64 here, double-single in the JAX package."""
    st = _batch("cassie")
    last = lambda a: np.ascontiguousarray(np.moveaxis(a, 0, -1))
    js = jax.jit(jrefined)(
        _split64(last(st["Q"])), _split64(last(st["A_eq"])),
        _split64(last(-st["b"])), _split64(last(st["b_eq"])))
    x = np.asarray(ds.to_f64(js))
    tx = kkt_solve_refined_ds(
        *(torch.from_numpy(last(a))
          for a in (st["Q"], st["A_eq"], -st["b"], st["b_eq"])))
    assert _rel(tx.numpy(), x) < 1e-9
