"""The port's plain statevector engine vs the JAX XLA engine.

complex128 is held at 1e-12 (the JAX engine is itself pinned at 1e-12 against
native/qsim_ref.cpp); complex64 at 2e-6 for states and 5e-6 for features, the
bars of tests/test_pallas_circuit.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dqgp_tpu.models.circuits import ENCODING_TYPES, build_circuit
from dqgp_tpu.ops import statevector as jsv
from dqgp_tpu.ops.circuit import (
    CRX, CRY, CRZ, CX, CZ, ENC_ARCCOS, ENC_ID, H, RX, RY, RZ, RZZ, Circuit, Gate,
)
from dqgp_tpu_torch.convert import circuit_from_jax
from dqgp_tpu_torch.ops import statevector as tsv
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ATOL = {torch.complex128: (1e-12, 1e-12), torch.complex64: (2e-6, 5e-6)}
JDT = {torch.complex128: jnp.complex128, torch.complex64: jnp.complex64}
RDT = {torch.complex128: (torch.float64, jnp.float64),
       torch.complex64: (torch.float32, jnp.float32)}


def all_kinds_circuit():
    """Every one of the 10 gate kinds, with both feature encodings."""
    gates = (
        Gate(H, 0), Gate(RX, 1, pidx=0, pc=1.0, fidx=0, fc=0.5, enc=ENC_ID),
        Gate(RY, 2, pidx=1, pc=1.0), Gate(RZ, 0, fidx=1, fc=2.0, enc=ENC_ARCCOS),
        Gate(CX, 1, control=0), Gate(CZ, 2, control=1),
        Gate(CRX, 0, control=2, pidx=2, pc=1.0),
        Gate(CRY, 2, control=0, pidx=3, pf=1.0, fidx=0, enc=ENC_ARCCOS),
        Gate(CRZ, 1, control=2, pidx=4, pc=1.0, const=0.3),
        Gate(RZZ, 0, control=2, pidx=5, pc=1.0), Gate(H, 2),
        Gate(RY, 1, pidx=6, pc=1.0),
    )
    return Circuit(3, 2, 7, gates, name="all_kinds")


CIRCUITS = {enc: build_circuit(enc, 3, 2, 2) for enc in ENCODING_TYPES}
CIRCUITS["all_kinds"] = all_kinds_circuit()


def _inputs(c, seed=0, n=7):
    rng = np.random.RandomState(seed)
    return rng.uniform(-0.95, 0.95, (n, c.num_features)), rng.uniform(0, np.pi, c.num_parameters)


def test_every_gate_kind_covered():
    assert {g.kind for g in CIRCUITS["all_kinds"].gates} == set(range(10))


@pytest.mark.parametrize("cdtype", [torch.complex128, torch.complex64])
@pytest.mark.parametrize("name", sorted(CIRCUITS))
def test_states_and_features_match_jax(name, cdtype):
    cj = CIRCUITS[name]
    ct = circuit_from_jax(cj)
    X, th = _inputs(cj)
    tdt, jdt = RDT[cdtype]
    a_j = jsv.angle_matrix(cj, jnp.asarray(X), jnp.asarray(th), jdt)
    a_t = tsv.angle_matrix(ct, torch.as_tensor(X), torch.as_tensor(th), tdt)
    # angles: exact up to the last ulp of the trig/arccos kernels (|a| < 10)
    np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j), rtol=0,
                               atol=1e-13 if tdt == torch.float64 else 2e-6)
    # same angles into both engines, so the comparison is of the engines
    s_j = jsv.state_from_angles(cj, a_j, JDT[cdtype])
    s_t = tsv.state_from_angles(ct, torch.tensor(np.asarray(a_j)), cdtype)
    atol_s, atol_f = ATOL[cdtype]
    assert s_t.dtype == cdtype
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=0, atol=atol_s)
    f_t = tsv.pauli_features(s_t, ct.num_qubits)
    assert f_t.dtype == tdt
    np.testing.assert_allclose(f_t.numpy(), np.asarray(jsv.pauli_features(s_j, cj.num_qubits)),
                               rtol=0, atol=atol_f)
    for p in ("XIZ", "YYX", "ZZZ", "IXY"):
        np.testing.assert_allclose(
            tsv.pauli_string_expectation(s_t, p).numpy(),
            np.asarray(jsv.pauli_string_expectation(s_j, p)), rtol=0, atol=atol_f)


def test_batched_angle_matrix_matches_rowwise():
    c = circuit_from_jax(CIRCUITS["chebyshev"])
    X, _ = _inputs(CIRCUITS["chebyshev"], n=5)
    thetas = torch.as_tensor(np.random.RandomState(3).uniform(0, np.pi, (4, c.num_parameters)))
    Xt = torch.as_tensor(X)
    batched = tsv.angle_matrix(c, Xt[None], thetas, torch.float64)
    for i in range(4):
        np.testing.assert_array_equal(batched[i].numpy(),
                                      tsv.angle_matrix(c, Xt, thetas[i], torch.float64).numpy())


def test_pauli_string_length_checked():
    s = tsv.state_from_angles(circuit_from_jax(CIRCUITS["yz_cx"]),
                              torch.zeros((1, CIRCUITS["yz_cx"].num_gates)))
    with pytest.raises(ValueError):
        tsv.pauli_string_expectation(s, "XX")
