"""k-fold cross-validation of consensus hyperparameters (NLPD model selection).

Port of ``dqgp_tpu/models/gp/cv.py`` (reference: main.py:1490-1596). The
per-sample features are computed ONCE per consensus vector (one kernel
launch), fold Grams are gathered sub-blocks, and the folds are a batch
dimension of one posterior solve. Fold indices replicate sklearn's
``KFold(shuffle=True, random_state=seed)`` in numpy (the reference seeds it
with ``seed + iter`` each iteration, main.py:2665).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ... import config, tracing
from ..kernels.quantum_kernel import (
    QuantumKernelSpec,
    gram_from_features,
    kernel_features,
)
from .metrics import _LOG_2PI, _np, outer_diag
from .posterior import gp_posterior_from_grams


def kfold_pad_indices_np(n: int, k: int, seed: int):
    """sklearn-compatible shuffled k-fold indices, padded to static shapes.

    sklearn's KFold shuffles ``arange(n)`` with ``RandomState(seed)``, cuts
    it into k folds whose first ``n % k`` are one larger, and returns both
    index sets of each fold in ascending order. Returns (train_idx,
    train_mask, val_idx, val_mask), int32, shapes (k, t_max) / (k, v_max);
    padding uses index 0 with mask 0."""
    if k < 2:
        raise ValueError(f"k-fold cross-validation requires at least 2 folds, got {k}")
    if k > n:
        raise ValueError(f"Cannot have number of splits n_splits={k} greater "
                         f"than the number of samples: n_samples={n}.")
    indices = np.arange(n)
    np.random.RandomState(seed).shuffle(indices)
    sizes = np.full(k, n // k, dtype=int)
    sizes[: n % k] += 1
    folds = []
    start = 0
    for size in sizes:
        val = np.zeros(n, bool)
        val[indices[start:start + size]] = True
        folds.append((np.flatnonzero(~val), np.flatnonzero(val)))
        start += size
    t_max = max(len(tr) for tr, _ in folds)
    v_max = max(len(va) for _, va in folds)

    tr_i = np.zeros((k, t_max), np.int32)
    tr_m = np.zeros((k, t_max), np.int32)
    va_i = np.zeros((k, v_max), np.int32)
    va_m = np.zeros((k, v_max), np.int32)
    for f, (tr, va) in enumerate(folds):
        tr_i[f, : len(tr)], tr_m[f, : len(tr)] = tr, 1
        va_i[f, : len(va)], va_m[f, : len(va)] = va, 1
    return tr_i, tr_m, va_i, va_m


def kfold_pad_indices(n: int, k: int, seed: int, device):
    """Tensor form of :func:`kfold_pad_indices_np`: int64 indices and
    float64 masks on ``device`` (four uploads; the driver fills
    :class:`FoldIndexBuffers` instead)."""
    tr_i, tr_m, va_i, va_m = kfold_pad_indices_np(n, k, seed)
    idx = lambda a: torch.as_tensor(a, dtype=torch.int64, device=device)
    msk = lambda a: torch.as_tensor(a, dtype=torch.float64, device=device)
    return idx(tr_i), msk(tr_m), idx(va_i), msk(va_m)


class FoldIndexBuffers:
    """Fold indices and masks of ``rows`` CV passes in one int64 device
    buffer that the caller owns, filled from one packed host array per call
    (one upload), as the JAX driver packs them (driver.py:553-562, 787-790).
    A CUDA graph captured over :meth:`folds` views reads whatever the last
    :meth:`fill` wrote. Fold shapes depend only on (n, k)."""

    def __init__(self, n: int, k: int, rows: int, device):
        tr_i, _, va_i, _ = kfold_pad_indices_np(n, k, 0)
        self.n, self.k = n, k
        self._shapes = (tr_i.shape, tr_i.shape, va_i.shape, va_i.shape)
        self.packed = torch.zeros((rows, 2 * (tr_i.size + va_i.size)),
                                  dtype=torch.int64, device=device)

    def fill(self, seeds) -> None:
        """Write the folds of ``seeds`` (one per row, at most ``rows``) into
        the buffer's first rows, each row [train idx | train mask | val idx |
        val mask] flattened: one host-to-device copy."""
        packed = np.stack([np.concatenate([a.ravel() for a in kfold_pad_indices_np(
            self.n, self.k, int(s))]) for s in seeds]).astype(np.int64)
        self.packed[:len(packed)].copy_(torch.from_numpy(packed))

    def folds(self, row: int):
        """(train idx, train mask, val idx, val mask) of ``row``: views of
        the buffer (the masks as int64 0/1; the fold scoring casts them)."""
        out, at = [], 0
        for shape in self._shapes:
            size = shape[0] * shape[1]
            out.append(self.packed[row, at:at + size].view(shape))
            at += size
        return tuple(out)


def cv_fold_scores_impl(
    spec: QuantumKernelSpec,
    X: torch.Tensor,
    Y: torch.Tensor,
    theta: torch.Tensor,
    tr_i: torch.Tensor,
    tr_m: torch.Tensor,
    va_i: torch.Tensor,
    va_m: torch.Tensor,
    noise_std: float = 0.1,
    jitter: float = 1e-6,
    cv_dtype: str = "float64",
    rescue: bool = False,
):
    """Per-fold (nlpd, r2, rmse), each (k,), with the folds as one batch.

    The folds use the ``direct-flag`` solver: a failed factorization scores
    NaN rather than running the eigh-pinv rescue, and nothing synchronises
    with the host (a CUDA graph captures the pass). ``rescue=True`` (the
    driver's re-score of a flagged iteration) restores the full fallback
    chain, as the reference's predict path rescues a failed Cholesky with
    an explicit inverse (main.py:1476-1482). ``cv_dtype`` "float32" keeps
    the features, fold Grams and solves in float32, as the JAX package's
    does (cv.py:107-128)."""
    dtype = config.torch_dtype(cv_dtype)
    F = kernel_features(spec, X, theta)  # once per consensus vector
    solver = "direct" if rescue else "direct-flag"
    # In float64 the features are upcast BEFORE the fold Grams.
    if dtype == torch.float64:
        F = F.to(torch.complex128 if spec.kernel_type == "fidelity" else dtype)

    tr_mask = tr_m.to(dtype)
    va_mask = va_m.to(dtype)
    F_tr = F[tr_i] * tr_mask[..., None].to(F.dtype)
    F_va = F[va_i]
    y_tr = Y[tr_i].to(dtype) * tr_mask
    y_va = Y[va_i].to(dtype)

    K_tt = gram_from_features(spec, F_tr).to(dtype)
    K_vt = gram_from_features(spec, F_va, F_tr).to(dtype)
    if spec.kernel_type == "fidelity":
        K_vv_diag = torch.ones(F_va.shape[:-1], dtype=dtype, device=F.device)
    else:
        K_vv_diag = outer_diag(spec.outer_kernel, F_va, spec.outer_params).to(dtype)

    mean, var, _ = gp_posterior_from_grams(
        K_tt, K_vt, K_vv_diag, y_tr, noise_std, jitter,
        train_mask=tr_mask, solver=solver,
    )
    r = y_va - mean
    var_safe = torch.clamp(var, min=1e-10)
    per_point = 0.5 * _LOG_2PI + 0.5 * torch.log(var_safe) + 0.5 * r * r / var_safe
    nv = torch.sum(va_mask, dim=-1)
    fold_nlpd = torch.sum(per_point * va_mask, dim=-1) / nv
    ss_res = torch.sum(r * r * va_mask, dim=-1)
    y_mean = torch.sum(y_va * va_mask, dim=-1) / nv
    ss_tot = torch.sum((y_va - y_mean[..., None]) ** 2 * va_mask, dim=-1)
    fold_r2 = 1.0 - ss_res / ss_tot
    fold_rmse = torch.sqrt(ss_res / nv)
    return fold_nlpd, fold_r2, fold_rmse


def aggregate_cv_scores(nlpds, r2s, rmses, k_folds: int) -> Dict:
    """Reference failure semantics (main.py:1564-1596): non-finite folds
    score +inf; valid only if >= k//2 folds succeed."""
    nlpds, r2s, rmses = _np(nlpds), _np(r2s), _np(rmses)

    fold_nlpds = [float(v) if np.isfinite(v) else float("inf") for v in nlpds]
    fold_r2s = [float(v) if np.isfinite(nlpds[i]) else -float("inf")
                for i, v in enumerate(r2s)]
    fold_rmses = [float(v) if np.isfinite(nlpds[i]) else float("inf")
                  for i, v in enumerate(rmses)]

    valid = [v for v in fold_nlpds if not np.isinf(v)]
    if len(valid) >= k_folds // 2:
        mean_nlpd = float(np.mean(valid))
        std_nlpd = float(np.std(valid))
        mean_r2 = float(np.mean([r for r, v in zip(fold_r2s, fold_nlpds)
                                 if not np.isinf(v)]))
        mean_rmse = float(np.mean([r for r, v in zip(fold_rmses, fold_nlpds)
                                   if not np.isinf(v)]))
    else:
        mean_nlpd = float("inf")
        std_nlpd = float("inf")
        mean_r2 = -float("inf")
        mean_rmse = float("inf")

    return {
        "mean_nlpd": mean_nlpd,
        "std_nlpd": std_nlpd,
        "mean_r2": mean_r2,
        "mean_rmse": mean_rmse,
        "fold_nlpds": fold_nlpds,
        "fold_r2s": fold_r2s,
        "fold_rmses": fold_rmses,
        "valid_folds": len(valid),
        "total_folds": k_folds,
    }


def k_fold_cross_validation_consensus(
    spec: QuantumKernelSpec,
    X_train: torch.Tensor,
    Y_train: torch.Tensor,
    consensus_params: torch.Tensor,
    noise_std: float,
    k_folds: int = 5,
    random_seed: int = 42,
    jitter: float = 1e-6,
    cv_dtype: str = "float64",
    rescue: bool = False,
) -> Dict:
    """Aggregate CV results with the reference's failure semantics.

    Runs on the device of ``X_train``. A fold flagged non-finite by the
    ``direct-flag`` pass at ``cv_dtype`` triggers a float64 re-score with
    the full fallback chain (``rescue=True``); ``rescue=True`` skips the
    flag pass (cv.py:211-257 of the JAX package)."""
    dev = X_train.device
    folds = kfold_pad_indices(int(X_train.shape[0]), k_folds, random_seed, dev)
    args = (spec, X_train, Y_train,
            torch.as_tensor(consensus_params, dtype=torch.float64, device=dev),
            *folds)
    kw = dict(noise_std=float(noise_std), jitter=float(jitter))
    flagged = rescue
    if not rescue:
        nlpds, r2s, rmses = cv_fold_scores_impl(*args, cv_dtype=cv_dtype, **kw)
        with tracing.span("sync.cv_check"):
            flagged = not bool(torch.all(torch.isfinite(nlpds)))
    if flagged:
        nlpds, r2s, rmses = cv_fold_scores_impl(*args, cv_dtype="float64", rescue=True, **kw)
    return aggregate_cv_scores(nlpds, r2s, rmses, k_folds)
