"""The JAX reference fixture of the fidelity-kernel run
(tests/fixtures/torch_port_fidelity.json, written by
scripts/record_torch_port_fidelity.py) agrees with the port on the CPU, at
the full size chip_smoke.py runs on the card, before any card time is spent:
the dataset recomputed by the port matches the fixture's digest and Y, and
the port's whole run — 5 ADMM iterations and predict, then 2 iterations
with fusion on — passes the bars chip_smoke.py holds the card to.
"""

import json

import numpy as np
import pytest
import torch

import chip_smoke as cs
from dqgp_tpu_torch import config
from dqgp_tpu_torch import driver as TD
from dqgp_tpu_torch.models.gp.metrics import evaluate_predictions
from dqgp_tpu_torch.models.gp.posterior import predict_quantum_gp


@pytest.fixture(scope="module")
def problem():
    with open(cs.FIDELITY_FIXTURE) as f:
        return json.load(f), cs.fidelity_problem("cpu")


def test_fixture_dataset_digest(problem):
    ref, (spec, X, Y, theta, X_tr, Y_tr, X_te, Y_te, splits) = problem
    p = ref["problem"]
    assert (spec.circuit.num_gates, spec.num_parameters, spec.circuit.dim) == (23, 12, 64)
    assert cs.array_digest(X) == p["x_sha256"]
    np.testing.assert_array_equal(theta, p["theta_star"])
    np.testing.assert_allclose(Y, p["Y"], rtol=0, atol=1e-8)
    assert [len(x) for x, _ in splits] == p["shard_sizes"] == [225] * 4
    assert (len(X_tr), len(X_te)) == (900, 100)
    assert cs.FID_AGENTS * (2 * spec.num_parameters + 1) * 225 == cs.FID_STEP_ROWS


@pytest.mark.parametrize("fusion,iters", [("auto", cs.FID_ITERS),
                                          ("on", cs.FID_FUSED_ITERS)])
def test_fixture_matches_port_run(problem, fusion, iters, monkeypatch):
    monkeypatch.setattr(config, "use_fusion", fusion)
    ref, (spec, X, Y, theta, X_tr, Y_tr, X_te, Y_te, splits) = problem
    res = TD.train(spec, splits, X_tr, Y_tr,
                   TD.TrainConfig(max_iter=iters, verbose=False, seed=cs.FID_SEED),
                   ground_truth_params=theta, device="cpu")
    cs.check_fidelity_run(res, ref, iters, fusion)
    if iters == ref["iterations"]:
        assert res.converged_by == ref["converged_by"]
        mean, var = predict_quantum_gp(spec, torch.tensor(X_tr), torch.tensor(Y_tr),
                                       torch.tensor(X_te), torch.tensor(res.z))
        nlpd = evaluate_predictions(Y_te, mean, var)["nlpd"]
        t_ref = ref["test_metrics"]["nlpd"]
        assert abs(nlpd - t_ref) <= max(
            cs.NLPD_TOL, 2 * abs(t_ref - ref["test_nlpd_f64_features"]))
