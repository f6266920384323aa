"""K1's float32 kernel as the CPU reaches it, against the JAX package: the
numpy model of the lane/register split (tests/test_torch_states_warp.py)
runs the unfused gate sequence with qubit q on bit q and then the model of
csrc/warp_state.cuh's reduce_features (register qubits paired inside the
lane, lane qubits with the partner lane, the lanes' sums in a butterfly, lane
f mod L writing feature f), and is held to ``dqgp_tpu``'s XLA engine and to
``make_pallas_pauli_features_fn`` in interpret mode on the same
float32-representable angles, at the float32 bar of
tests/test_pallas_circuit.py.

Interpret mode compiles each circuit anew (2-16 s each), so its cases run
one-layer circuits on two rows; the XLA engine's run two layers on three.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from dqgp_tpu.models.circuits import ENCODING_TYPES, build_circuit
from dqgp_tpu.ops import circuit as jc
from dqgp_tpu.ops import statevector as jsv
from dqgp_tpu.ops.pallas_circuit import make_pallas_pauli_features_fn
from dqgp_tpu_torch.convert import circuit_from_jax

from test_torch_states_warp import (
    K1_MODEL_QUBITS, _every_kind_circuit, _random_angles, model_features)

ATOL = 5e-6  # float32 features, as tests/test_pallas_circuit.py holds them


def _jax_circuit(c):
    """The JAX package's twin of a port circuit (the same gate fields)."""
    fields = ("kind", "qubit", "control", "const", "pidx", "pc", "fidx", "fc", "pf", "enc")
    gates = tuple(jc.Gate(**{f: getattr(g, f) for f in fields}) for g in c.gates)
    return jc.Circuit(num_qubits=c.num_qubits, num_features=c.num_features,
                      num_parameters=c.num_parameters, gates=gates, name=c.name)


def _model_and_angles(c, rows, seed):
    a32 = _random_angles(c, rows, seed).astype(np.float32)
    return model_features(c, a32.astype(np.float64)), jnp.asarray(a32)


@pytest.mark.parametrize("n", K1_MODEL_QUBITS)
@pytest.mark.parametrize("enc", ENCODING_TYPES)
def test_k1_model_matches_xla_engine(enc, n):
    jax_circuit = build_circuit(enc, n, 2, 2)
    got, a = _model_and_angles(circuit_from_jax(jax_circuit), 3, seed=50 + n)
    want = np.asarray(jsv.pauli_features(jsv.state_from_angles(jax_circuit, a), n))
    assert got.shape == want.shape == (3, 3 * n)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("n", K1_MODEL_QUBITS)
@pytest.mark.parametrize("enc", ENCODING_TYPES)
def test_k1_model_matches_pallas_interpret(enc, n):
    jax_circuit = build_circuit(enc, n, 2, 1)
    got, a = _model_and_angles(circuit_from_jax(jax_circuit), 2, seed=60 + n)
    want = np.asarray(make_pallas_pauli_features_fn(jax_circuit, interpret=True)(a))
    assert got.shape == want.shape == (2, 3 * n)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("n,seed", [(6, 0), (10, 0), (10, 1)])
def test_k1_model_every_gate_kind_matches_jax(n, seed):
    """CRX, CRY, CRZ, CZ, RZZ and CX with controls on register bits and on
    lane bits, against both JAX engines."""
    c = _every_kind_circuit(n, seed)
    assert {g.control >= 5 for g in c.gates if g.control >= 0} == {True, False}
    jax_circuit = _jax_circuit(c)
    got, a = _model_and_angles(c, 2, seed=70 + n)
    xla = np.asarray(jsv.pauli_features(jsv.state_from_angles(jax_circuit, a), n))
    pallas = np.asarray(make_pallas_pauli_features_fn(jax_circuit, interpret=True)(a))
    np.testing.assert_allclose(got, xla, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got, pallas, rtol=0, atol=ATOL)
