"""Tests that need the card: the CUDA circuit kernels — Pauli features (K1,
float32 and float64), states (K2, float32 and float64), fused-program Pauli
features (K3) and fused-program states (K4) — against their plain PyTorch
versions, on CUDA tensors. They skip where there is no card.

On a GPU host, where JAX need not be installed (the port does not use it),
bypass conftest.py, which imports JAX:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import pytest
import torch

from dqgp_tpu_torch import config
from dqgp_tpu_torch.models.circuits import ENCODING_TYPES, build_circuit
from dqgp_tpu_torch.models.kernels import QuantumKernelSpec
from dqgp_tpu_torch.models.kernels import quantum_kernel as TQ
from dqgp_tpu_torch.ops import cuda_circuit as K1

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("enc", ENCODING_TYPES)
def test_kernel_matches_plain_on_card(cuda, enc):
    gen = torch.Generator(device=cuda).manual_seed(1)
    for n in range(1, K1.MAX_QUBITS + 1):  # every instantiation of the float32 kernel
        c = build_circuit(enc, n, 2, 2)
        for B in (1, 257):
            a = (torch.rand((B, c.num_gates), generator=gen, device=cuda) * 4 - 1) * 3.14159
            before = K1.pauli_features_from_angles.launches
            got = K1.pauli_features_from_angles(c, a)
            torch.cuda.synchronize()
            assert K1.pauli_features_from_angles.launches == before + 1
            want = K1.pauli_features_reference(c, a)
            # float32 features (tests/test_pallas_circuit.py's bar)
            assert float((got - want).abs().max()) <= 5e-6


def _angles(gen, c, B, dtype):
    return (torch.rand((B, c.num_gates), generator=gen, device=gen.device,
                       dtype=dtype) * 4 - 1) * 3.14159


@pytest.mark.parametrize("enc", ENCODING_TYPES)
def test_states_kernels_match_plain_on_card(cuda, enc):
    """K2 float32 at 2e-6 (tests/test_pallas_circuit.py), K2 and K1 float64
    at 1e-12 (tests/test_native.py), K4 at 3e-6 (tests/test_fusion.py)
    against the plain fused engine and the plain unfused states, for every
    qubit count the kernels are built for (both sides of the register/lane
    split), one launch a call."""
    gen = torch.Generator(device=cuda).manual_seed(2)
    for n in range(1, K1.MAX_QUBITS + 1):
        c = build_circuit(enc, n, 2, 2)
        for B in (1, 257):
            a32, a64 = _angles(gen, c, B, torch.float32), _angles(gen, c, B, torch.float64)
            before = K1.launch_counts()
            got = {
                "K2": K1.states_from_angles(c, a32),
                "K2_f64": K1.states_from_angles(c, a64),
                "K1_f64": K1.pauli_features_from_angles(c, a64),
                "K4": K1.states_from_angles_fused(c, a32),
            }
            torch.cuda.synchronize()
            after = K1.launch_counts()
            assert all(after[k] == before[k] + 1 for k in got)
            assert got["K2"].shape == got["K4"].shape == (B, 1 << n)
            assert got["K2"].dtype == got["K4"].dtype == torch.complex64
            plain = K1.states_reference(c, a32)
            assert float((got["K2"] - plain).abs().max()) <= 2e-6
            assert float((got["K4"] - plain).abs().max()) <= 3e-6
            assert float((got["K4"] - K1.states_fused_reference(c, a32)).abs().max()) <= 3e-6
            assert float((got["K2_f64"] - K1.states_reference(c, a64)).abs().max()) <= 1e-12
            assert float((got["K1_f64"] - K1.pauli_features_reference(c, a64))
                         .abs().max()) <= 1e-12


def test_card_fidelity_features_go_through_k2_and_k4(cuda, monkeypatch):
    """K4 takes the angles: nothing on the card's path builds packed rows
    (fusion.packed_inputs raises if anything calls it)."""
    from dqgp_tpu_torch.ops import fusion

    c = build_circuit("kyriienko", 6, 1, 1)
    spec = QuantumKernelSpec(circuit=c, kernel_type="fidelity")
    a = torch.zeros((4, c.num_gates), device=cuda)
    K1.reset_launch_counts()
    TQ.features_from_angles(spec, a)
    TQ.features_from_angles(spec, a.double())
    monkeypatch.setattr(config, "use_fusion", "on")

    def no_packed_rows(*args):
        raise AssertionError("packed rows built on the card's path")

    monkeypatch.setattr(fusion, "packed_inputs", no_packed_rows)
    monkeypatch.setattr(fusion, "su2_products", no_packed_rows)
    TQ.features_from_angles(spec, a)
    assert K1.launch_counts() == {"K1": 0, "K1_f64": 0, "K2": 1, "K2_f64": 1, "K3": 0,
                                  "K4": 1}


@pytest.mark.parametrize("enc", ENCODING_TYPES)
def test_fused_features_kernel_matches_plain_on_card(cuda, enc):
    """K3 at 8e-6 (tests/test_fusion.py) against the plain fused engine and
    K1's plain unfused version, for every qubit count it is built for (both
    sides of the register/lane split), one launch a call."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    for n in range(1, K1.MAX_QUBITS + 1):
        c = build_circuit(enc, n, 2, 2)
        for B in (1, 257):
            a = _angles(gen, c, B, torch.float32)
            before = K1.launch_counts()["K3"]
            got = K1.pauli_features_from_angles_fused(c, a)
            torch.cuda.synchronize()
            assert K1.launch_counts()["K3"] == before + 1
            assert got.shape == (B, 3 * n) and got.dtype == torch.float32
            assert float((got - K1.pauli_features_fused_reference(c, a)).abs().max()) <= 8e-6
            assert float((got - K1.pauli_features_reference(c, a)).abs().max()) <= 8e-6


def test_card_fused_projected_features_go_through_k3(cuda, monkeypatch):
    """Per-qubit projected features take K3 where fusion is on (at 10 qubits
    under "auto"), K1 where it is off, and K1's float64 instantiation for
    float64 angles whatever the switch says."""
    c = build_circuit("chebyshev", 10, 2, 2)
    spec = QuantumKernelSpec(circuit=c, kernel_type="projected")
    a = torch.zeros((4, c.num_gates), device=cuda)
    K1.reset_launch_counts()
    monkeypatch.setattr(config, "use_fusion", "auto")
    TQ.features_from_angles(spec, a)
    TQ.features_from_angles(spec, a.double())
    monkeypatch.setattr(config, "use_fusion", "off")
    TQ.features_from_angles(spec, a)
    assert K1.launch_counts() == {"K1": 1, "K1_f64": 1, "K2": 0, "K2_f64": 0, "K3": 1,
                                  "K4": 0}
