"""Parity with the JAX package, on the CPU, of the solver options this
port added last: over-relaxation (``alpha``) and adaptive rho on the
reduced path, and the parity engine on f32 data.

The JAX side runs its plain XLA chunk bodies (``use_pallas=False``: its
Pallas kernels take no alpha), the port the plain versions its kernel
wrappers take for CPU tensors. Over-relaxation in the full layout is held
against the JAX package in `tests/test_torch_batched_fast.py`."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fcc_qp_tpu_torch as T
from fcc_qp_tpu import FCCQPOptions as JOpts
from fcc_qp_tpu import solve_batched as jsolve_batched
from fcc_qp_tpu.core.ds_engine import solve_batched_ds as jsolve
from fcc_qp_tpu.core.ds_engine import to_ds_batch as jto
from fcc_qp_tpu.models.osc import (CASSIE, generate_osc_batch,
                                   generate_osc_sequence)
from fcc_qp_tpu.utils.io import stack_qp_dicts, to_qpbatch
from fcc_qp_tpu_torch.ops import pallas_admm as tk
from fcc_qp_tpu_torch.utils.io import to_qpbatch as tto

torch.set_num_threads(1)

# the two-phase path of tests/test_torch_slice.py with alpha = 1.6 and
# bench.py --adaptive-rho (interval 100, one adaptation): both chunk
# kernels' plain versions run the relaxation, and rho adapts after the
# approach phase's chunks and the endgame's
RELAXED_ADAPTIVE = dict(
    max_iter=2000, rho=0.05, eps_fcone=1e-6, eps_bound=1e-6,
    presolve="operator", scaling=True, splitting="constrained",
    polish=False, phase1_tol=1e-2, alpha=1.6, adaptive_rho=True,
    adaptive_rho_interval=100, adaptive_rho_max_adaptations=1,
)


def test_reduced_path_alpha_and_adaptive_rho_match_jax():
    st = stack_qp_dicts(generate_osc_batch(CASSIE, 16, seed=5))
    jsol, _ = jsolve(jto(st), CASSIE.shape, JOpts(**RELAXED_ADAPTIVE),
                     timing=False)
    stages = {}
    tsol, _ = T.solve_batched_ds(T.to_ds_batch(st, device="cpu"),
                                 CASSIE.shape,
                                 T.FCCQPOptions(**RELAXED_ADAPTIVE),
                                 device="cpu", stage_times=stages)
    for name in ("solve_status", "n_iter", "n_iter_f32", "n_iter_ds"):
        np.testing.assert_array_equal(
            getattr(tsol.details, name).numpy(),
            np.asarray(getattr(jsol.details, name)), err_msg=name)
    assert np.abs(tsol.z.numpy() - np.asarray(jsol.z)).max() <= 1e-8
    assert stages["n_refactor"] == 1
    assert (tsol.details.solve_status.numpy() == 0).mean() >= 0.8


# bench.py --engine f32 at a tolerance above the f32 floor: at 1e-6 the
# increment gate asks |x_new - x| < 1e-6 of coordinates near 100 (one f32
# ulp there is 7.6e-6), so convergence waits for an exact f32 fixed point
# and is decided by rounding: the XLA and PyTorch f32 operators differ by
# about 4e-6 relative and their mat-vecs sum in different orders
F32 = dict(max_iter=3000, rho=0.05, eps_fcone=1e-4, eps_bound=1e-4,
           presolve="operator")


def test_f32_parity_engine_matches_jax():
    st = stack_qp_dicts(generate_osc_sequence(CASSIE, 16, seed=0))
    jsol, _ = jsolve_batched(to_qpbatch(st, dtype=jnp.float32), CASSIE.shape,
                             JOpts(**F32), timing=False)
    tk.reset_launch_counts()
    tsol, tws = T.solve_batched(tto(st, dtype=torch.float32, device="cpu"),
                                CASSIE.shape, T.FCCQPOptions(**F32),
                                device="cpu")
    assert tsol.z.dtype == torch.float32 and tws.mu_x.dtype == torch.float32
    assert all(fn.launches == 0 for fn in tk.KERNELS)
    st_t = tsol.details.solve_status.numpy()
    np.testing.assert_array_equal(st_t, np.asarray(jsol.details.solve_status))
    assert (st_t == 0).all()
    jn = np.asarray(jsol.details.n_iter)
    tn = tsol.details.n_iter.numpy()
    assert (np.abs(tn - jn) <= np.ceil(0.01 * jn)).all()
    jz = np.asarray(jsol.z)
    rel = np.abs(tsol.z.numpy() - jz).max(axis=1) / (1 + np.abs(jz).max(axis=1))
    assert rel.max() <= 2e-3
    res = np.maximum(tsol.details.admm_residual_bounds.numpy(),
                     tsol.details.admm_residual_friction_cone.numpy())
    assert (res < np.float32(1e-4)).all()


@pytest.mark.parametrize("layout", ["reduced_f64", "reduced_f32", "full_f64",
                                    "full_f32"])
def test_alpha_one_is_the_unrelaxed_iteration(layout):
    """alpha = 1 runs no relaxation (the results of every earlier slice);
    alpha = 1.6 changes the iterates."""
    from test_torch_port_rules import _chunk_inputs, _full_chunk_inputs

    prec = layout.split("_")[1]
    dtype = torch.float32 if prec == "f32" else torch.float64
    args, kw = _chunk_inputs(dtype)
    name = "admm_chunk_" + ("full_" if layout.startswith("full") else "") + prec
    if layout.startswith("full"):
        args, kw = _full_chunk_inputs(args, kw)
    plain = getattr(tk, name + "_plain")
    base = plain(*args, **kw)
    one = plain(*args, **kw, alpha=1.0)
    relaxed = plain(*args, **kw, alpha=1.6)
    for a, b in zip(base, one):
        assert torch.equal(a, b)
    assert not torch.equal(base[0], relaxed[0])
