"""The JAX float64 reference fixture that chip_smoke.py holds the card to
agrees with the port on the CPU, at the full north-star size, before any
card time is spent.

The port replays the fixture's first 2 iterations. z of iteration 1 depends
only on the seeded initial state and must be equal at 4 dp; z of iteration 2
follows one gradient step through float32 features, where the two engines'
last-ulp differences may flip the last of the 4 digits (1e-4) of a component
(9 of 40 components flip here). CV-NLPD: 0.05 (bench.py:60).
"""

import contextlib
import io
import json
from pathlib import Path

import numpy as np

import chip_smoke as cs
from dqgp_tpu_torch import driver as TD
from dqgp_tpu_torch.data import split_data_numpy
from dqgp_tpu_torch.models.circuits import build_circuit
from dqgp_tpu_torch.models.kernels import QuantumKernelSpec
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

FIXTURE = Path(__file__).resolve().parent / "fixtures" / "torch_port_northstar.json"


def test_fixture_matches_port_first_two_iterations():
    ref = json.loads(FIXTURE.read_text())
    X, Y, X_test, Y_test = cs.make_problem()
    assert cs.problem_digest(X, Y, X_test, Y_test) == ref["problem"]["sha256"]
    spec = QuantumKernelSpec(
        circuit=build_circuit("chebyshev", cs.NUM_QUBITS, cs.NUM_FEATURES, cs.NUM_LAYERS),
        kernel_type="projected", outer_kernel="matern")
    with contextlib.redirect_stdout(io.StringIO()):
        splits = split_data_numpy(X, Y, cs.N_AGENTS, "regional")
    assert [x.shape[0] for x, _ in splits] == ref["problem"]["shard_sizes"]
    res = TD.train(spec, splits, X, Y, TD.TrainConfig(max_iter=2, verbose=False),
                   device="cpu")
    z = np.array([h["consensus_params"] for h in res.cv_history])
    z_ref = np.array(ref["z_trajectory"][:2])
    np.testing.assert_array_equal(np.round(z[0], 4), np.round(z_ref[0], 4))
    assert np.abs(z[1] - z_ref[1]).max() <= 1e-4 + 1e-9
    cv = np.array([h["consensus_cv_score"] for h in res.cv_history])
    np.testing.assert_allclose(cv, ref["cv_nlpd"][:2], rtol=0, atol=cs.NLPD_TOL)
