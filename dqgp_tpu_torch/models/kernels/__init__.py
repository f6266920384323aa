from .outer import OUTER_KERNELS, outer_gram  # noqa: F401
from .quantum_kernel import (  # noqa: F401
    QuantumKernel,
    QuantumKernelSpec,
    create_quantum_kernel,
    gram,
    gram_and_shift_grads,
    kernel_features,
)
