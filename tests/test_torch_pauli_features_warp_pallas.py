"""K1's model of the lane/register split against ``dqgp_tpu``'s Pallas
kernel in interpret mode, up to 6 qubits. The model's helper and its
XLA-engine cases are in tests/test_torch_pauli_features_warp.py, 8 and 10
qubits in tests/test_torch_pauli_features_warp_pallas_wide.py: interpret
mode compiles each circuit anew, so the cases are spread over files that
the suite's workers run side by side.
"""

import pytest

from dqgp_tpu.models.circuits import ENCODING_TYPES
from test_torch_pauli_features_warp import hold_model_to_pallas_interpret
from test_torch_states_warp import K1_MODEL_QUBITS
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("n", [n for n in K1_MODEL_QUBITS if n <= 6])
@pytest.mark.parametrize("enc", ENCODING_TYPES)
def test_k1_model_matches_pallas_interpret(enc, n):
    hold_model_to_pallas_interpret(enc, n)
