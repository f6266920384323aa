"""Synthetic data: quantum-GP sampling and classical test functions.

Port of ``dqgp_tpu/data/synthetic.py`` with the same numpy RNG sequence, so
fixed seeds give the same X, ground-truth parameters, z and noise as the JAX
package and the reference:

* ``generate_quantum_gp_data`` (main.py:161-292): theta* ~ U(0, pi) under
  ``np.random.seed(param_seed)`` rounded to 4 dp; X ~ U(data_range) under
  ``np.random.seed(data_seed)`` (time-based if None); inputs of arccos
  circuits clipped to [-0.99, 0.99]; the Gram K built on ``device`` in one
  batched pass (on the card: the float64 states kernel, then the Gram's real
  matmuls); 1e-6 jitter; Y = chol(K) z + noise, with an eigendecomposition
  fallback (eigenvalues clamped >= 1e-10). Jitter, Cholesky and the fallback
  run in numpy on the host, as in the JAX package.
* ``generate_data_numpy`` (main.py:457-522): 1D sine mix, 2D log-normalized
  Goldstein-Price, 3D negated Hartmann.
* ``save_quantum_dataset`` (main.py:433-455): the CSV export.
"""

from __future__ import annotations

import os
import time
from typing import Optional, Tuple

import numpy as np
import torch

from ..models.kernels.quantum_kernel import QuantumKernelSpec, gram

_GRAM_DTYPES = {"auto": torch.float64, "float64": torch.float64,
                "float32": torch.float32}


def generate_quantum_gp_data(
    num_samples: int,
    input_dim: int,
    spec: QuantumKernelSpec,
    data_range: Tuple[float, float] = (-2.0, 2.0),
    noise_std: float = 0.1,
    kernel_params: Optional[np.ndarray] = None,
    data_seed: Optional[int] = None,
    param_seed: int = 42,
    verbose: bool = False,
    gram_dtype: str = "auto",
    *,
    device,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Sample (X, Y, theta*) from a quantum-GP prior. Reference main.py:161-292.

    ``gram_dtype`` is the precision of the ground-truth Gram K. The reference
    builds it in double precision (qiskit-aer statevectors), so ``"auto"``
    is float64, as the JAX package resolves it wherever complex128 is native
    (CPU and GPU). The numpy RNG sequence is the same for either precision;
    only K's entries move."""
    if input_dim < 1 or input_dim > 6:
        raise ValueError(f"Input dimension must be between 1 and 6, got {input_dim}")
    if spec.circuit.num_features != input_dim:
        raise ValueError("spec.circuit.num_features must equal input_dim")
    if gram_dtype not in _GRAM_DTYPES:
        raise ValueError(
            f"gram_dtype must be 'auto'/'float32'/'float64', got {gram_dtype!r}")

    P = spec.num_parameters
    if kernel_params is not None:
        if len(kernel_params) != P:
            raise ValueError(f"Expected {P} parameters, got {len(kernel_params)}")
        ground_truth_params = np.round(np.asarray(kernel_params, np.float64).copy(), 4)
    else:
        np.random.seed(param_seed)
        ground_truth_params = np.round(np.random.uniform(0, np.pi, P), 4)

    if data_seed is None:
        data_seed = int(time.time() * 1000) % 2**32  # reference: main.py:216-218
    np.random.seed(data_seed)
    if verbose:
        print(f"Using data generation seed: {data_seed}")

    X = np.random.uniform(data_range[0], data_range[1], size=(num_samples, input_dim))
    if spec.circuit.requires_clipping:
        X = np.clip(X, -0.99, 0.99)  # arccos domain guard (main.py:224-236)

    dtype = _GRAM_DTYPES[gram_dtype]
    K_t = gram(spec, torch.as_tensor(X, dtype=dtype, device=device),
               torch.as_tensor(ground_truth_params, dtype=dtype, device=device),
               dtype=dtype)
    K = K_t.detach().cpu().numpy().astype(np.float64)  # a host copy: mutated below
    if np.any(np.isnan(K)) or np.any(np.isinf(K)):
        raise ValueError("Kernel matrix contains NaN or infinite values")

    K[np.diag_indices_from(K)] += 1e-6
    try:
        L = np.linalg.cholesky(K)
        z = np.random.normal(0, 1, num_samples)
        Y = L @ z
        Y = Y + np.random.normal(0, noise_std, num_samples)
    except np.linalg.LinAlgError:
        eigenvals, eigenvecs = np.linalg.eigh(K)
        eigenvals = np.maximum(eigenvals, 1e-10)
        z = np.random.normal(0, 1, num_samples)
        Y = eigenvecs @ (np.sqrt(eigenvals) * z)
        Y = Y + np.random.normal(0, noise_std, num_samples)

    return X, Y, ground_truth_params


def generate_data_numpy(
    num_samples: int,
    input_dim: int = 1,
    noise_std: float = 0.1,
    data_seed: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Classical test functions (main.py:457-522), RNG-identical."""
    if data_seed is None:
        data_seed = int(time.time() * 1000) % 2**32
    np.random.seed(data_seed)

    if input_dim == 1:
        X = np.random.uniform(0, 1, size=(num_samples, 1))
        x = X[:, 0]
        Y = 5 * x**2 * np.sin(12 * x) + (x**3 - 0.5) * np.sin(3 * x - 0.5) + 4 * np.cos(2 * x)
        Y = Y + np.random.normal(0, noise_std, num_samples)
    elif input_dim == 2:
        X = np.random.uniform(-2.0, 2.0, size=(num_samples, 2))
        x1, x2 = X[:, 0], X[:, 1]
        fact1 = 1 + (x1 + x2 + 1) ** 2 * (
            19 - 14 * x1 + 3 * x1**2 - 14 * x2 + 6 * x1 * x2 + 3 * x2**2
        )
        fact2 = 30 + (2 * x1 - 3 * x2) ** 2 * (
            18 - 32 * x1 + 12 * x1**2 + 48 * x2 - 36 * x1 * x2 + 27 * x2**2
        )
        Y = (np.log(fact1 * fact2) - 8.693) / 2.427
        Y = Y + np.random.normal(0, noise_std, num_samples)
    elif input_dim == 3:
        X = np.random.uniform(0.0, 1.0, size=(num_samples, 3))
        alpha = np.array([1.0, 1.2, 3.0, 3.2])
        A = np.array([[3.0, 10.0, 30.0], [0.1, 10.0, 35.0],
                      [3.0, 10.0, 30.0], [0.1, 10.0, 35.0]])
        Pm = 1e-4 * np.array([[3689.0, 1170.0, 2673.0], [4699.0, 4387.0, 7470.0],
                              [1091.0, 8732.0, 5547.0], [381.0, 5743.0, 8828.0]])
        Y = np.zeros(num_samples)
        for i in range(4):
            inner = np.sum(A[i, :] * (X - Pm[i, :]) ** 2, axis=1)
            Y += alpha[i] * np.exp(-inner)
        Y = -Y
        Y = Y + np.random.normal(0, noise_std, num_samples)
    else:
        raise ValueError(f"Unsupported input dimension: {input_dim}")
    return X, Y


def save_quantum_dataset(X, Y, dataset_name: str, output_dir: str = "quantum_datasets") -> str:
    """CSV export ``{name}_{d}d_{N}.csv`` with header ``X1,...,Xd,Y``
    (main.py:433-455). Returns the file's path."""
    os.makedirs(output_dir, exist_ok=True)
    combined = np.column_stack((X, Y))
    filename = os.path.join(output_dir, f"{dataset_name}_{X.shape[1]}d_{X.shape[0]}.csv")
    header = ",".join([f"X{i+1}" for i in range(X.shape[1])] + ["Y"])
    np.savetxt(filename, combined, delimiter=",", header=header, comments="")
    return filename
