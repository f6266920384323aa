"""dqgp_tpu_torch — the PyTorch/CUDA port of ``dqgp_tpu``.

The same distributed quantum-GP regression (quantum-kernel GPs whose encoding
circuit parameters are optimized by multi-agent Riemannian ADMM consensus on
a torus), in PyTorch, with the Pauli-feature kernel written by hand in CUDA
for Hopper (``csrc/pauli_features.cu``). The module paths mirror the JAX
package's, which stays the reference the port is tested against. The port
imports torch and numpy, never jax.

Precision: features in float32 (the kernel), the GP side in float64, TF32
off (``config``).
"""

from . import config  # noqa: F401  (applies the precision policy)
from . import manifold  # noqa: F401
from .agent import RiemannianAgent  # noqa: F401
from .driver import TrainConfig, TrainResult, host_condition_numbers, train  # noqa: F401
from .manifold import (  # noqa: F401
    RiemannianADMM,
    RiemannianOptimizer,
    TorusManifold,
    create_riemannian_framework,
)
from .models.circuits import build_circuit  # noqa: F401
from .models.kernels import (  # noqa: F401
    QuantumKernel,
    QuantumKernelSpec,
    create_quantum_kernel,
)

__version__ = "0.1.0"
