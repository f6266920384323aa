"""Prediction metrics and NLPD — twin of the reference's evaluate suite.

Port of ``dqgp_tpu/models/gp/metrics.py`` (reference: main.py:1598-1736 and
the NLPD formula shared by the CV path, main.py:1546-1552). ``outer_diag``
runs on tensors; the metrics are host-side numpy on small vectors.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

_LOG_2PI = float(np.log(2.0 * np.pi))


def outer_diag(name: str, F: torch.Tensor, params: Optional[dict] = None) -> torch.Tensor:
    """k(x, x) for each feature row (..., N, D) — the projected Gram diagonal."""
    p = dict(params or {})
    ones = torch.ones(F.shape[:-1], dtype=F.dtype, device=F.device)
    if name in ("gaussian", "matern", "expsinesquared", "rationalquadratic"):
        return ones
    if name == "dotproduct":
        sigma_0 = p.get("sigma_0", 1.0)
        return sigma_0 * sigma_0 + torch.sum(F * F, dim=-1)
    if name == "pairwisekernel":
        metric = p.get("metric", "linear")
        if metric == "linear":
            return torch.sum(F * F, dim=-1)
        if metric == "rbf":
            return ones
        if metric == "poly":
            gamma = p.get("gamma", 1.0)
            coef0 = p.get("coef0", 1.0)
            degree = p.get("degree", 3)
            return (gamma * torch.sum(F * F, dim=-1) + coef0) ** degree
    raise ValueError(f"Unknown outer kernel {name!r}")


def _np(x) -> np.ndarray:
    if torch.is_tensor(x):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)


def nlpd(y_true, y_pred_mean, y_pred_var, eps: float = 1e-10) -> float:
    """Mean negative log predictive density (main.py:1546-1552, 1652-1662)."""
    y_true = _np(y_true)
    mean = _np(y_pred_mean)
    var = np.maximum(_np(y_pred_var), eps)
    residuals = y_true - mean
    per_point = 0.5 * _LOG_2PI + 0.5 * np.log(var) + 0.5 * residuals**2 / var
    return float(np.mean(per_point))


def evaluate_predictions(
    Y_true,
    Y_pred,
    Y_pred_var=None,
    dataset_type: str = "Test",
    verbose: bool = False,
) -> Dict[str, float]:
    """Full metric suite (main.py:1598-1736): MSE/RMSE/MAE/R2/max-err,
    residual stats, 1σ/2σ coverage, uncertainty-normalized RMSE, NLPD with
    qualitative buckets, range-normalized RMSE. Accepts tensors or arrays."""
    Y_true = _np(Y_true)
    Y_pred = _np(Y_pred)

    residuals = Y_true - Y_pred
    mse = float(np.mean(residuals**2))
    rmse = float(np.sqrt(mse))
    mae = float(np.mean(np.abs(residuals)))
    ss_res = float(np.sum(residuals**2))
    ss_tot = float(np.sum((Y_true - Y_true.mean()) ** 2))
    r2 = 1.0 - ss_res / ss_tot if ss_tot > 0 else 0.0
    max_error = float(np.max(np.abs(residuals)))
    mean_residual = float(np.mean(residuals))
    std_residual = float(np.std(residuals))

    if r2 > 0.9:
        performance = "Excellent"
    elif r2 > 0.7:
        performance = "Good"
    elif r2 > 0.5:
        performance = "Fair"
    else:
        performance = "Poor"

    y_range = float(Y_true.max() - Y_true.min())
    normalized_rmse_range = rmse / y_range if y_range > 0 else float("inf")

    metrics: Dict[str, float] = {
        "mse": mse,
        "rmse": rmse,
        "mae": mae,
        "r2": r2,
        "max_error": max_error,
        "mean_residual": mean_residual,
        "std_residual": std_residual,
        "normalized_rmse_range": normalized_rmse_range,
        "performance": performance,
    }

    if Y_pred_var is not None:
        var = _np(Y_pred_var)
        std = np.sqrt(var)
        within_1sigma = float(np.mean(np.abs(residuals) <= std))
        within_2sigma = float(np.mean(np.abs(residuals) <= 2 * std))
        mean_uncertainty = float(np.mean(std))
        normalized_rmse_uncertainty = float(np.sqrt(np.mean((residuals / std) ** 2)))
        nlpd_val = nlpd(Y_true, Y_pred, var)

        if within_1sigma > 0.5 and within_2sigma > 0.8:
            uncertainty_quality = "Good"
        elif within_1sigma > 0.4 and within_2sigma > 0.7:
            uncertainty_quality = "Fair"
        else:
            uncertainty_quality = "Poor"

        metrics.update(
            mean_uncertainty=mean_uncertainty,
            within_1sigma=within_1sigma,
            within_2sigma=within_2sigma,
            normalized_rmse_uncertainty=normalized_rmse_uncertainty,
            nlpd=nlpd_val,
            uncertainty_quality=uncertainty_quality,
        )

    if verbose:
        print(f"=== {dataset_type} Set Evaluation ===")
        for k, v in metrics.items():
            print(f"  {k}: {v}")
    return metrics
