"""Low-level compute: circuit IR, statevector engine, the CUDA Pauli-feature
kernel and GP linear algebra."""

from .circuit import Circuit, Gate, ENC_ID, ENC_ARCCOS, ENC_NONE  # noqa: F401
from .statevector import (  # noqa: F401
    angle_matrix,
    pauli_features,
    state_from_angles,
)
