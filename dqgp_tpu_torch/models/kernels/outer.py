"""Outer kernels for the projected quantum kernel, in PyTorch.

Port of ``dqgp_tpu/models/kernels/outer.py``. Defaults match sklearn /
squlearn defaults because the reference's CLI outer-kernel hyperparameters
never reach the main-path kernels (main.py:127-133): gaussian gamma=1.0,
matern length_scale=1.0 nu=1.5, expsinesquared length_scale=1.0
periodicity=1.0, rationalquadratic length_scale=1.0 alpha=1.0, dotproduct
sigma_0=1.0, pairwisekernel metric='linear' gamma=1.0.

Features may carry leading batch dimensions: FA (..., N, D), FB (..., M, D)
-> (..., N, M), so the 2P+1 shifted Grams of every agent come from one call.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from ... import config

OUTER_KERNELS = (
    "gaussian", "matern", "expsinesquared", "rationalquadratic",
    "dotproduct", "pairwisekernel",
)


def _dot(FA: torch.Tensor, FB: torch.Tensor) -> torch.Tensor:
    if FA.is_cuda:
        config.check_full_precision_matmul()
    return FA @ FB.transpose(-1, -2)


def _sqdist(FA: torch.Tensor, FB: torch.Tensor) -> torch.Tensor:
    """Pairwise squared euclidean distances via one matmul."""
    sq_a = torch.sum(FA * FA, dim=-1, keepdim=True)
    sq_b = torch.sum(FB * FB, dim=-1, keepdim=True)
    d2 = sq_a + sq_b.transpose(-1, -2) - 2.0 * _dot(FA, FB)
    return torch.clamp(d2, min=0.0)


def outer_gram(name: str, FA: torch.Tensor, FB: torch.Tensor,
               params: Optional[Dict[str, float]] = None) -> torch.Tensor:
    """Gram matrix of the named outer kernel between feature sets."""
    p = dict(params or {})
    if name == "gaussian":
        gamma = p.get("gamma", 1.0)
        return torch.exp(-gamma * _sqdist(FA, FB))

    if name == "matern":
        ls = p.get("length_scale", 1.0)
        nu = p.get("nu", 1.5)
        d = torch.sqrt(_sqdist(FA, FB) + 1e-30) / ls
        if nu == 0.5:
            return torch.exp(-d)
        if nu == 1.5:
            k = d * math.sqrt(3.0)
            return (1.0 + k) * torch.exp(-k)
        if nu == 2.5:
            k = d * math.sqrt(5.0)
            return (1.0 + k + k * k / 3.0) * torch.exp(-k)
        if nu == float("inf"):
            return torch.exp(-0.5 * d * d)
        raise NotImplementedError(
            f"Matern nu={nu}: only the closed forms nu in {{0.5, 1.5, 2.5, inf}} "
            "are supported (general nu needs Bessel K_v).")

    if name == "expsinesquared":
        ls = p.get("length_scale", 1.0)
        periodicity = p.get("periodicity", 1.0)
        d = torch.sqrt(_sqdist(FA, FB) + 1e-30)
        s = torch.sin(math.pi * d / periodicity)
        return torch.exp(-2.0 * (s / ls) ** 2)

    if name == "rationalquadratic":
        ls = p.get("length_scale", 1.0)
        alpha = p.get("alpha", 1.0)
        d2 = _sqdist(FA, FB)
        return (1.0 + d2 / (2.0 * alpha * ls * ls)) ** (-alpha)

    if name == "dotproduct":
        sigma_0 = p.get("sigma_0", 1.0)
        return sigma_0 * sigma_0 + _dot(FA, FB)

    if name == "pairwisekernel":
        metric = p.get("metric", "linear")
        gamma = p.get("gamma", 1.0)
        if metric == "linear":
            return _dot(FA, FB)
        if metric == "rbf":
            return torch.exp(-gamma * _sqdist(FA, FB))
        if metric == "poly":
            degree = p.get("degree", 3)
            coef0 = p.get("coef0", 1.0)
            return (_dot(gamma * FA, FB) + coef0) ** degree
        raise NotImplementedError(f"pairwisekernel metric={metric!r}")

    raise ValueError(f"Unknown outer kernel {name!r}. Supported: {OUTER_KERNELS}")
