"""Marginal-likelihood noise fitting (beyond the reference).

Port of ``dqgp_tpu/models/gp/noise.py``. The reference treats ``noise_std``
as a CLI constant (main.py:1958) that both samples synthetic data and
parameterizes every GP fit, which is misspecified on real data: fitting
sigma by the training marginal likelihood at the selected hyperparameters,
plus the observed-Y predictive variance (``--predictive-noise``), is what
calibrates the SRTM runs (docs/PERFORMANCE.md, round 4: maharashtra 2-sigma
coverage 0.48 -> 0.95).

One symmetric eigendecomposition of the noise-free training Gram
K = V diag(w) V^T, after which the negative log marginal likelihood at any
sigma is O(N) in the eigenbasis:

    nmll(sigma) = 1/2 sum_i log(w_i + s) + 1/2 sum_i q_i^2 / (w_i + s)
                  + N/2 log(2 pi),        s = sigma^2 + jitter, q = V^T y

The Gram is built in float64 on ``device`` (on the card through K1's or
K2's float64 kernel) and decomposed there with ``torch.linalg.eigh``; only
w and q^2 come back. The coarse grid and the golden-section refinement over
log sigma run on the host, line for line as in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..kernels.quantum_kernel import QuantumKernelSpec, gram


class NoiseFitResult(NamedTuple):
    noise_std: float        # argmax-likelihood sigma
    nmll: float             # negative log marginal likelihood at the optimum
    nmll_at_input: float    # same at the caller's current sigma (comparison)
    grid_sigma: np.ndarray  # coarse-grid abscissae (diagnostics/plots)
    grid_nmll: np.ndarray


def _nmll_from_eigs(w: np.ndarray, q2: np.ndarray, sigma: float,
                    jitter: float) -> float:
    s = sigma * sigma + jitter
    d = w + s
    return float(0.5 * np.sum(np.log(d)) + 0.5 * np.sum(q2 / d)
                 + 0.5 * len(w) * np.log(2.0 * np.pi))


def fit_noise_std(
    spec: QuantumKernelSpec,
    X_train: np.ndarray,
    Y_train: np.ndarray,
    theta: np.ndarray,
    current_noise_std: float = 0.1,
    jitter: float = 1e-6,
    bounds: Tuple[float, float] = (1e-3, 3.0),
    grid_points: int = 48,
    K=None,
    *,
    device,
) -> NoiseFitResult:
    """Fit ``noise_std`` by maximizing the training marginal likelihood.

    A caller that already has the noise-free training Gram can pass it as
    ``K`` (numpy or tensor); it is decomposed on ``device`` in float64.
    Eigenvalues are clamped at 0 (roundoff negatives) so every gridpoint's
    log term is finite."""
    f64 = torch.float64
    if K is None:
        K = gram(spec, torch.as_tensor(np.asarray(X_train), dtype=f64, device=device),
                 torch.as_tensor(np.asarray(theta), dtype=f64, device=device), dtype=f64)
    else:
        K = torch.as_tensor(K, device=device).to(f64)
    w_t, V = torch.linalg.eigh(K)
    y = torch.as_tensor(np.asarray(Y_train), dtype=f64, device=K.device)
    w = np.maximum(w_t.cpu().numpy(), 0.0)
    q2 = ((V.transpose(0, 1) @ y) ** 2).cpu().numpy()

    lo, hi = bounds
    grid = np.geomspace(lo, hi, grid_points)
    vals = np.array([_nmll_from_eigs(w, q2, s, jitter) for s in grid])
    i = int(np.argmin(vals))

    # golden-section refinement on log sigma, bracketed by the grid
    a = np.log(grid[max(i - 1, 0)])
    b = np.log(grid[min(i + 1, grid_points - 1)])
    invphi = (np.sqrt(5.0) - 1.0) / 2.0
    c, d = b - invphi * (b - a), a + invphi * (b - a)
    fc = _nmll_from_eigs(w, q2, float(np.exp(c)), jitter)
    fd = _nmll_from_eigs(w, q2, float(np.exp(d)), jitter)
    for _ in range(40):
        if fc < fd:
            b, d, fd = d, c, fc
            c = b - invphi * (b - a)
            fc = _nmll_from_eigs(w, q2, float(np.exp(c)), jitter)
        else:
            a, c, fc = c, d, fd
            d = a + invphi * (b - a)
            fd = _nmll_from_eigs(w, q2, float(np.exp(d)), jitter)
    sigma = float(np.exp((a + b) / 2.0))
    return NoiseFitResult(
        noise_std=sigma,
        nmll=_nmll_from_eigs(w, q2, sigma, jitter),
        nmll_at_input=_nmll_from_eigs(w, q2, current_noise_std, jitter),
        grid_sigma=grid,
        grid_nmll=vals,
    )
