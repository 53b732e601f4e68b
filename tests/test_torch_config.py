"""Port parity of the static configuration and the numpy model
generators: `fcc_qp_tpu_torch` keeps its own copies of
`fcc_qp_tpu/config.py` and `fcc_qp_tpu/models/osc.py`, which must agree
with the JAX package's field for field and array for array."""

import dataclasses

import numpy as np
import pytest
import torch

import fcc_qp_tpu.config as jcfg
import fcc_qp_tpu.models.osc as josc
import fcc_qp_tpu.types as jtypes
import fcc_qp_tpu_torch.config as tcfg
import fcc_qp_tpu_torch.models.osc as tosc
import fcc_qp_tpu_torch.types as ttypes

# torch's CPU thread pool runs the port's small batched products many
# times slower at its default thread count than at one or two, and the
# suite's test workers share the cores
torch.set_num_threads(1)


def _fields(cls):
    return [(f.name, f.default) for f in dataclasses.fields(cls)]


@pytest.mark.parametrize("name", ["FCCQPOptions", "ProblemShape"])
def test_config_fields_and_defaults_match(name):
    assert _fields(getattr(tcfg, name)) == _fields(getattr(jcfg, name))


def test_options_validation_matches():
    bad = [dict(max_iter=0), dict(rho=0.0), dict(alpha=2.0),
           dict(presolve="x"), dict(splitting="x"), dict(kkt_factor="x"),
           dict(polish_rounds=0), dict(phase1_tol=-1.0)]
    for kw in bad:
        with pytest.raises(ValueError):
            jcfg.FCCQPOptions(**kw)
        with pytest.raises(ValueError):
            tcfg.FCCQPOptions(**kw)
    assert tcfg.CASSIE_SHAPE == tcfg.ProblemShape(60, 38, 12, 38)
    with pytest.raises(ValueError):
        tcfg.ProblemShape(10, 2, 4, 0)


def test_result_types_match():
    assert [f.name for f in dataclasses.fields(ttypes.FCCQPDetails)] == [
        f.name for f in dataclasses.fields(jtypes.FCCQPDetails)
    ]
    assert {s.name: int(s) for s in ttypes.FCCQPSolveStatus} == {
        s.name: int(s) for s in jtypes.FCCQPSolveStatus
    }


def test_models_match():
    assert set(tosc.MODELS) == set(josc.MODELS)
    for name, m in tosc.MODELS.items():
        j = josc.MODELS[name]
        assert dataclasses.asdict(m) == dataclasses.asdict(j)
        assert dataclasses.astuple(m.shape) == dataclasses.astuple(j.shape)


def _assert_logs_equal(a, b):
    assert len(a) == len(b)
    for qa, qb in zip(a, b):
        assert qa.keys() == qb.keys()
        for k in qa:
            np.testing.assert_array_equal(qa[k], qb[k])


@pytest.mark.parametrize("model", ["cassie", "quadruped", "humanoid"])
def test_generate_osc_batch_identical(model):
    _assert_logs_equal(
        tosc.generate_osc_batch(tosc.MODELS[model], 12, seed=3),
        josc.generate_osc_batch(josc.MODELS[model], 12, seed=3),
    )


def test_generate_osc_batch_random_phase_identical():
    _assert_logs_equal(
        tosc.generate_osc_batch(tosc.CASSIE, 8, seed=1, random_phase=True),
        josc.generate_osc_batch(josc.CASSIE, 8, seed=1, random_phase=True),
    )


def test_generate_osc_sequence_identical():
    _assert_logs_equal(
        tosc.generate_osc_sequence(tosc.CASSIE, 6, seed=0, smoothness=0.002),
        josc.generate_osc_sequence(josc.CASSIE, 6, seed=0, smoothness=0.002),
    )
