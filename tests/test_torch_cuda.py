"""Tests that need the card: the CUDA Pauli-feature kernel (K1) against its
plain PyTorch version, on CUDA tensors. They skip where there is no card.

On a GPU host, where JAX need not be installed (the port does not use it),
bypass conftest.py, which imports JAX:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import pytest
import torch

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
    for n in (1, 3, 6, 10):
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


def test_card_rejects_unported_requests(cuda):
    c = build_circuit("yz_cx", 2, 2, 1)
    a = torch.zeros((4, c.num_gates), device=cuda)
    with pytest.raises(NotImplementedError, match="K2"):
        TQ.features_from_angles(QuantumKernelSpec(circuit=c, kernel_type="fidelity"), a)
    with pytest.raises(NotImplementedError, match="float64"):
        TQ.features_from_angles(QuantumKernelSpec(circuit=c, kernel_type="projected"),
                                a.double())
