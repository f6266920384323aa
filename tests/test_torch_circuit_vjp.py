"""The adjoint kernel (``csrc/circuit_vjp.cu``), the backward of K1 and K2.

The CPU has no nvcc, so the kernel itself runs only on the card
(tests/test_torch_cuda.py and chip_smoke.py hold it to its plain version
there). Here a numpy model of its algorithm — the forward sequence, the
seed lambda = 2 O psi or the state's cotangent, then the gates walked
backwards with 1/2 Im <lambda|P|phi> and the inverse gates on both states —
is held to the plain version (``torch.autograd`` through the plain engine)
on circuits that use all ten gate kinds, and the wrapper and
``CircuitFunction`` are held to finite differences and to JAX's gradient of
its own engine.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dqgp_tpu.models.circuits import build_circuit as jax_build_circuit
from dqgp_tpu.ops.statevector import pauli_features as jax_pauli_features
from dqgp_tpu.ops.statevector import state_from_angles as jax_state_from_angles
from dqgp_tpu_torch.models.circuits import ENCODING_TYPES, build_circuit
from dqgp_tpu_torch.models.kernels import QuantumKernelSpec
from dqgp_tpu_torch.models.kernels.quantum_kernel import features_from_angles
from dqgp_tpu_torch.ops import cuda_circuit as K
from dqgp_tpu_torch.ops.circuit import (
    CRX, CRY, CRZ, CX, CZ, RX, RY, RZ, RZZ, H, Circuit, Gate,
)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

_X = np.array([[0, 1], [1, 0]], complex)
_Y = np.array([[0, -1j], [1j, 0]])
_Z = np.diag([1.0, -1.0]).astype(complex)
_GENERATOR = {RX: _X, CRX: _X, RY: _Y, CRY: _Y, RZ: _Z, CRZ: _Z}


def all_kinds_circuit(n: int, seed: int = 0) -> Circuit:
    """A random n-qubit circuit with every gate kind (the two-qubit ones
    from 2 qubits), each rotation on its own angle column."""
    rng = np.random.RandomState(seed)
    two = (CX, CZ, CRX, CRY, CRZ, RZZ) if n > 1 else ()
    kinds = [RX, RY, RZ, H, *two] * 2
    rng.shuffle(kinds)
    gates = []
    for kind in kinds:
        q = int(rng.randint(n))
        ctl = -1
        if kind in two:
            ctl = int(rng.choice([c for c in range(n) if c != q]))
        gates.append(Gate(kind, q, ctl, const=0.0, pidx=-1))
    return Circuit(num_qubits=n, num_features=1, num_parameters=1, gates=tuple(gates))


def _gate_matrix(gate, a: float, n: int) -> np.ndarray:
    """The gate's 2^n x 2^n unitary at angle a (qubit q on bit q)."""
    dim = 1 << n
    k = np.arange(dim)
    bq = (k >> gate.qubit) & 1
    if gate.kind == H:
        u2 = np.array([[1, 1], [1, -1]]) / np.sqrt(2)
    elif gate.kind in (CX,):
        u2 = _X
    elif gate.kind == CZ:
        return np.diag(np.where(bq & ((k >> gate.control) & 1), -1.0, 1.0)).astype(complex)
    elif gate.kind == RZZ:
        agree = bq == ((k >> gate.control) & 1)
        return np.diag(np.exp(-0.5j * a * np.where(agree, 1.0, -1.0)))
    else:
        P = _GENERATOR[gate.kind]
        u2 = np.cos(a / 2) * np.eye(2) - 1j * np.sin(a / 2) * P
    U = np.eye(dim, dtype=complex)
    for k0 in k[bq == 0]:
        k1 = k0 | (1 << gate.qubit)
        if gate.control >= 0 and not (k0 >> gate.control) & 1:
            continue
        U[np.ix_([k0, k1], [k0, k1])] = u2
    return U


def _generator(gate, n: int) -> np.ndarray:
    """P with U(a) = exp(-i a/2 P) on the whole register."""
    dim = 1 << n
    k = np.arange(dim)
    if gate.kind == RZZ:
        agree = ((k >> gate.qubit) & 1) == ((k >> gate.control) & 1)
        return np.diag(np.where(agree, 1.0, -1.0)).astype(complex)
    P = np.zeros((dim, dim), complex)
    for k0 in k[((k >> gate.qubit) & 1) == 0]:
        k1 = k0 | (1 << gate.qubit)
        if gate.control >= 0 and not (k0 >> gate.control) & 1:
            continue
        P[np.ix_([k0, k1], [k0, k1])] = _GENERATOR[gate.kind]
    return P


def model_vjp(circuit: Circuit, angles: np.ndarray, cot: np.ndarray, output: str) -> np.ndarray:
    """circuit_vjp.cu's algorithm, one sample at a time, in complex128."""
    n, dim = circuit.num_qubits, circuit.dim
    out = np.zeros_like(angles)
    for b, a in enumerate(angles):
        phi = np.zeros(dim, complex)
        phi[0] = 1.0
        for g, gate in enumerate(circuit.gates):
            phi = _gate_matrix(gate, a[g], n) @ phi
        if output == "features":
            O = np.zeros((dim, dim), complex)
            for q in range(n):
                for j, P in enumerate((_X, _Y, _Z)):
                    term = np.array([[1.0]])
                    for qq in reversed(range(n)):  # qubit 0 is the last factor
                        term = np.kron(term, P if qq == q else np.eye(2))
                    O += cot[b, j * n + q] * term
            lam = 2.0 * O @ phi
        else:
            lam = cot[b].astype(complex)
        for g in reversed(range(circuit.num_gates)):
            gate = circuit.gates[g]
            if gate.kind not in (H, CX, CZ):
                out[b, g] = 0.5 * np.imag(np.vdot(lam, _generator(gate, n) @ phi))
            Uh = _gate_matrix(gate, a[g], n).conj().T
            phi, lam = Uh @ phi, Uh @ lam
    return out


def _cotangent(rng, circuit, B, output):
    if output == "features":
        return rng.uniform(-1, 1, (B, 3 * circuit.num_qubits))
    return rng.randn(B, circuit.dim) + 1j * rng.randn(B, circuit.dim)


@pytest.mark.parametrize("output", K.VJP_OUTPUTS)
@pytest.mark.parametrize("n", [1, 2, 3, 5])
def test_model_of_the_kernel_matches_autograd(n, output):
    circuit = all_kinds_circuit(n, seed=n)
    rng = np.random.RandomState(10 + n)
    B = 3
    angles = rng.uniform(-np.pi, np.pi, (B, circuit.num_gates))
    cot = _cotangent(rng, circuit, B, output)
    want = K.circuit_vjp_reference(circuit, torch.as_tensor(angles),
                                   torch.as_tensor(cot), output).numpy()
    np.testing.assert_allclose(model_vjp(circuit, angles, cot, output), want,
                               rtol=0, atol=1e-10)


@pytest.mark.parametrize("output", K.VJP_OUTPUTS)
def test_wrapper_runs_the_plain_version_on_the_cpu(output):
    circuit = build_circuit("chebyshev", 3, 2, 1)
    rng = np.random.RandomState(0)
    a = torch.as_tensor(rng.uniform(-np.pi, np.pi, (5, circuit.num_gates)), dtype=torch.float32)
    cot = torch.as_tensor(_cotangent(rng, circuit, 5, output)).to(
        torch.float32 if output == "features" else torch.complex64)
    K.reset_launch_counts()
    got = K.circuit_vjp(circuit, a, cot, output)
    assert K.launch_counts() == dict.fromkeys(K.launch_counts(), 0)
    torch.testing.assert_close(got, K.circuit_vjp_reference(circuit, a, cot, output),
                               rtol=0, atol=0)
    with pytest.raises(ValueError):
        K.circuit_vjp(circuit, a, cot, "gram")


@pytest.mark.parametrize("kernel_type,measurement", [("projected", "XYZ"), ("projected", "ZX"),
                                                     ("projected", ("XZY", "ZZI")),
                                                     ("fidelity", "XYZ")])
def test_circuit_function_gradient_matches_finite_differences(kernel_type, measurement):
    """features_from_angles on angles that need a gradient goes through
    CircuitFunction; torch.autograd.gradcheck holds its backward (the
    adjoint's plain version here) to central differences in float64."""
    spec = QuantumKernelSpec(circuit=build_circuit("yz_cx", 3, 2, 1), kernel_type=kernel_type,
                             measurement=measurement)
    a = torch.as_tensor(np.random.RandomState(1).uniform(-np.pi, np.pi, (2, spec.circuit.num_gates)),
                        dtype=torch.float64).requires_grad_(True)

    def f(x):
        out = features_from_angles(spec, x)
        return torch.view_as_real(out) if out.is_complex() else out

    assert torch.autograd.gradcheck(f, (a,), eps=1e-6, atol=1e-8)


@pytest.mark.parametrize("enc", ENCODING_TYPES)
@pytest.mark.parametrize("output", K.VJP_OUTPUTS)
def test_vjp_matches_jax_grad_of_its_engine(enc, output):
    """The same VJP as JAX's reverse mode through its float64 engine."""
    circuit = build_circuit(enc, 3, 2, 1)
    jc = jax_build_circuit(enc, 3, 2, 1)
    rng = np.random.RandomState(2)
    B = 4
    angles = rng.uniform(-np.pi, np.pi, (B, circuit.num_gates))
    cot = _cotangent(rng, circuit, B, output)
    if output == "features":
        fn = lambda a: jax_pauli_features(jax_state_from_angles(jc, a, jnp.complex128), 3)
        ct = jnp.asarray(cot)
    else:
        fn = lambda a: jax_state_from_angles(jc, a, jnp.complex128)
        # JAX's cotangent of a complex output is the conjugate of torch's
        ct = jnp.asarray(np.conj(cot))
    _, vjp = jax.vjp(fn, jnp.asarray(angles))
    want = np.asarray(vjp(ct)[0])
    got = K.circuit_vjp(circuit, torch.as_tensor(angles), torch.as_tensor(cot), output).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)
    np.testing.assert_allclose(model_vjp(circuit, angles, cot, output), want, rtol=0, atol=1e-10)
