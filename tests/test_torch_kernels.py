"""Port parity of the two ADMM chunk kernels' plain versions against the
Pallas kernels they replace, run in interpret mode (one 128-instance
tile, K=16) from a real prepared state: Cassie (k = 22 constrained rows)
and the humanoid (k = 47, above one warp's 32 lanes, the CUDA kernels'
two-slot layout).

The CUDA kernels themselves run only on the card, where `chip_smoke.py`
holds each against its plain version; here the plain versions (which
the wrappers take for CPU tensors) are held against the JAX package."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fcc_qp_tpu.config import ProblemShape as JShape
from fcc_qp_tpu.core.ds_engine import _split64
from fcc_qp_tpu.ops import ds
from fcc_qp_tpu.ops.pallas_admm import admm_chunk_pallas, admm_chunk_pallas32
from fcc_qp_tpu_torch import FCCQPOptions
from fcc_qp_tpu_torch.core import ds_engine as teng
from fcc_qp_tpu_torch.models.osc import CASSIE, HUMANOID, generate_osc_batch
from fcc_qp_tpu_torch.ops import pallas_admm as tk
from fcc_qp_tpu_torch.utils.io import stack_qp_dicts

# torch's CPU thread pool runs the port's small batched products many
# times slower at its default thread count than at one or two, and the
# suite's test workers share the cores
torch.set_num_threads(1)

B, K, MAX_ITER = 128, 16, 2000
# plain-version iterations run before the compared chunk, per model, so
# that convergence events fall inside it: (f32 chunk test, f64 chunk
# test's f32 approach, its f64 iterations). The humanoid's f32 approach
# reaches TAU from iteration 11 on, and its first f64 instances converge
# after 227 and 232 endgame iterations.
WARMUP = {"cassie": (90, 300, 150), "humanoid": (8, 300, 220)}
TAU = 1e-2
EPS = float(np.float32(1e-6))
OPTS = FCCQPOptions(
    max_iter=MAX_ITER, rho=0.05, eps_fcone=1e-6, eps_bound=1e-6,
    presolve="operator", scaling=True, splitting="constrained",
    polish=False, phase1_tol=TAU,
)


@pytest.fixture(scope="module", params=[CASSIE, HUMANOID],
                ids=lambda m: m.name)
def prepared(request):
    """Prepared operator + a mid-approach state of the port's engine."""
    model = request.param
    stacked = stack_qp_dicts(generate_osc_batch(model, B, seed=5))
    qp = teng.to_ds_batch(stacked, device="cpu")
    shape = model.shape
    ci = teng.constrained_indices(qp, shape)
    prep = teng._prepare_reduced(qp, None, shape, OPTS, False, ci)
    ci_t = torch.as_tensor(ci)
    k, nc = len(ci), shape.nc
    kb = k - nc
    op = dict(
        Fj=prep.Fcc, x_const=prep.xc_const,
        lb=prep.qps.lb[ci_t[:kb]].contiguous(),
        ub=prep.qps.ub[ci_t[:kb]].contiguous(),
        mu_f=prep.qps.friction_coeffs, wk=prep.d[ci_t].contiguous(),
        rho=prep.rho0, kb=kb,
    )
    x0 = prep.x_init[ci_t].float().double()
    zb = torch.zeros(B, dtype=torch.float64)
    state = dict(
        x=x0, s=x0, mu=prep.mu0, v=x0 - prep.mu0,
        done=torch.zeros(B, dtype=torch.bool),
        n_iter=torch.full((B,), MAX_ITER, dtype=torch.int32),
        itv=torch.zeros(B, dtype=torch.int32),
        xrn=zb, lrn=zb, prim=zb, dual=zb,
    )
    return op, state, WARMUP[model.name]


def _run_plain(fn, op, st, dtype, K_, eps_b, eps_f, **kw):
    c = lambda a: a.to(dtype) if a.is_floating_point() else a
    out = fn(
        c(op["Fj"]), c(op["x_const"]), c(op["lb"]), c(op["ub"]),
        c(op["mu_f"]), op["rho"].to(dtype), eps_b, eps_f,
        c(st["x"]), c(st["s"]), c(st["mu"]), c(st["v"]), st["done"],
        st["n_iter"], st["itv"], c(st["xrn"]), c(st["lrn"]),
        c(st["prim"]), c(st["dual"]),
        kb=op["kb"], K=K_, max_iter=MAX_ITER, weights=c(op["wk"]), **kw,
    )
    keys = ("x", "s", "mu", "v", "done", "n_iter", "itv",
            "xrn", "lrn", "prim", "dual")
    return dict(zip(keys, out))


def _masked_state(st):
    """Freeze some instances and put some at the iteration cap mid-chunk
    so the per-instance masking is exercised."""
    st = dict(st)
    st["done"] = st["done"].clone()
    st["done"][::9] = True
    st["itv"] = st["itv"].clone()
    st["itv"][4::13] = MAX_ITER - 5
    return st


def _pallas_inputs(op, st, split):
    """The Pallas wrappers' argument layout: lb/ub padded with -+inf on
    the cone rows, box and cone duals split."""
    kb = op["kb"]
    k = st["x"].shape[0]
    nc = k - kb
    inf = np.full((nc, B), np.inf)
    lb = np.concatenate([op["lb"].numpy(), -inf])
    ub = np.concatenate([op["ub"].numpy(), inf])
    mu = st["mu"].numpy()
    mu_x = np.concatenate([mu[:kb], np.zeros((nc, B))])
    shape = JShape(num_vars=k, num_eq=0, nc=nc, lambda_c_start=kb)
    f = split
    return dict(
        args=(
            f(op["Fj"].numpy()), f(op["x_const"].numpy()), f(lb), f(ub),
            f(op["mu_f"].numpy()), jnp.asarray(op["rho"].numpy()),
        ),
        state=(
            f(st["x"].numpy()), f(st["s"].numpy()), f(st["s"].numpy()[kb:]),
            f(mu_x), f(mu[kb:]), f(st["v"].numpy()),
            jnp.asarray(st["done"].numpy()), jnp.asarray(st["n_iter"].numpy()),
            jnp.asarray(st["itv"].numpy()),
        ),
        shape=shape,
        wk=jnp.asarray(op["wk"].numpy()),
        wl=jnp.asarray(op["wk"].numpy()[kb:]),
    )


def _compare(got, ref, st_in, kb, tol_state, tol_res):
    for name in ("done", "n_iter", "itv"):
        np.testing.assert_array_equal(got[name].numpy(), ref[name], name)
    for name in ("x", "s", "mu", "v"):
        np.testing.assert_allclose(
            got[name].double().numpy(), ref[name], rtol=0, atol=tol_state,
            err_msg=name,
        )
    # the Pallas kernels restart residuals from zero in every chunk:
    # compare them only where the instance iterated in this chunk
    act = got["itv"].numpy() > st_in["itv"].numpy()
    assert act.sum() > B // 2
    for name in ("xrn", "lrn", "prim", "dual"):
        a = got[name].double().numpy()[act]
        b = np.asarray(ref[name], np.float64)[act]
        np.testing.assert_allclose(a, b, rtol=tol_res, atol=1e-12, err_msg=name)
    # idle instances keep their incoming residuals (XLA chunk semantics)
    np.testing.assert_array_equal(
        got["xrn"].double().numpy()[~act],
        st_in["xrn"].double().numpy()[~act],
    )


def _unpack(out, kb, to_np):
    (x, xb, lb_, mux, mul, v, done, n_iter, itv, xrn, lrn, prim, dual) = out
    cat = lambda a, b: np.concatenate([to_np(a)[:kb], to_np(b)])
    return dict(
        x=to_np(x), s=cat(xb, lb_), mu=cat(mux, mul), v=to_np(v),
        done=np.asarray(done), n_iter=np.asarray(n_iter),
        itv=np.asarray(itv), xrn=np.asarray(xrn), lrn=np.asarray(lrn),
        prim=np.asarray(prim), dual=np.asarray(dual),
    )


def test_f32_chunk_matches_pallas32(prepared):
    op, st0, (n32, _, _) = prepared
    # approach the coarse point so convergence events fall in the chunk
    st = _run_plain(tk.admm_chunk_f32_plain, op, st0, torch.float32, n32,
                    TAU, TAU)
    st = _masked_state(st)
    got = _run_plain(tk.admm_chunk_f32_plain, op, st, torch.float32, K,
                     TAU, TAU)
    p = _pallas_inputs(op, st, lambda a: jnp.asarray(a, jnp.float32))
    out = admm_chunk_pallas32(
        *p["args"], TAU, TAU, *p["state"], shape=p["shape"], K=K,
        max_iter=MAX_ITER, interpret=True, weights=p["wk"],
        cone_weights=p["wl"],
    )
    ref = _unpack(out, op["kb"], lambda a: np.asarray(a, np.float64))
    assert (ref["done"] & ~st["done"].numpy()).any()
    _compare(got, ref, st, op["kb"], tol_state=1e-6, tol_res=1e-5)


def test_f64_chunk_matches_ds_pallas(prepared):
    op, st0, (_, n32, n64) = prepared
    # f32 approach, then f64 endgame iterations up to the point where
    # instances start to converge
    st = _run_plain(tk.admm_chunk_f32_plain, op, st0, torch.float32, n32,
                    TAU, TAU)
    st = {k_: (v.double() if v.is_floating_point() else v)
          for k_, v in st.items()}
    st["done"] = torch.zeros(B, dtype=torch.bool)
    st = _run_plain(tk.admm_chunk_f64_plain, op, st, torch.float64, n64,
                    EPS, EPS, inc_gate=True)
    st = _masked_state(st)
    got = _run_plain(tk.admm_chunk_f64_plain, op, st, torch.float64, K,
                     EPS, EPS, inc_gate=True)
    p = _pallas_inputs(op, st, _split64)
    out = admm_chunk_pallas(
        *p["args"], EPS, EPS, *p["state"], shape=p["shape"], K=K,
        max_iter=MAX_ITER, interpret=True, weights=p["wk"],
        cone_weights=p["wl"], inc_gate=True,
    )
    ref = _unpack(out, op["kb"], lambda a: np.asarray(ds.to_f64(a)))
    assert (ref["done"] & ~st["done"].numpy()).any()
    _compare(got, ref, st, op["kb"], tol_state=1e-10, tol_res=1e-5)
