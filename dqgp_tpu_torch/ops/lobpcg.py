"""Matrix-free LOBPCG: the top-k eigenpairs of a symmetric operator.

A copy of ``jax.experimental.sparse.linalg.lobpcg_standard`` (the
standard eigenproblem A U = lambda U, no preconditioner), which the JAX
package's low-rank eigenvalue clip calls, so that both packages stop at the
same rule:

* the same input checks (``k * 5 < n``, the operator's dtype and shape);
* SVQB orthonormalisation with column truncation (``_svqb``), residuals
  projected out of [X, P] twice (``_project_out``);
* Rayleigh-Ritz over the orthonormal block [X, P, R];
* the same convergence test (a residual below ``tol * 10 * n * (|A v| +
  lambda)``, ``tol`` the dtype's epsilon by default) and the same iteration
  cap ``m``.

``A`` is a callable on (n, j) blocks, so the matrix is never formed (the
clip's operator is the feature-factored Gram, 20 GB at 49,999 float64
rows); ``torch.lobpcg`` takes a tensor and would need it. Plain PyTorch on
whatever device ``X`` lives on; the loop reads one count a iteration.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch


def lobpcg_standard(
    A: Callable[[torch.Tensor], torch.Tensor],
    X: torch.Tensor,
    m: int = 100,
    tol: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Top-k eigenpairs of the symmetric operator ``A`` from the start
    block ``X`` (n, k), ``0 < 5k < n``. Returns (theta (k,) descending, U
    (n, k), iterations)."""
    n, k = X.shape
    _check_inputs(A, X)
    if tol is None:
        tol = float(torch.finfo(X.dtype).eps)

    X = _orthonormalize(X)
    P = _extend_basis(X, X.shape[1])

    # X (best eigenvectors), P (search directions) and R (residuals) are
    # kept orthonormal; R and P columns may be zero after truncation
    AX = A(X)
    theta = torch.sum(X * AX, dim=0, keepdim=True)
    R = AX - theta * X

    i, converged = 0, 0
    while i < m and converged < k:
        R = _project_out(torch.cat((X, P), dim=1), R)
        XPR = torch.cat((X, P, R), dim=1)

        theta, Q = _rayleigh_ritz_orth(A, XPR)

        B = Q[:, :k]
        B = B / torch.linalg.norm(B, dim=0, keepdim=True)
        X = XPR @ B
        X = X / torch.linalg.norm(X, dim=0, keepdim=True)

        # the new directions: concat(0, Q[k:, :k]) orthogonalised against
        # Q[:, :k] in the standard basis, mapped through the orthonormal XPR
        q, _ = torch.linalg.qr(Q[:k, k:].T)
        P = XPR @ (Q[:, k:] @ q)
        normP = torch.linalg.norm(P, dim=0, keepdim=True)
        P = P / torch.where(normP == 0, torch.ones_like(normP), normP)

        AX = A(X)
        R = AX - theta[None, :k] * X
        resid_norms = torch.linalg.norm(R, dim=0)
        reltol = (torch.linalg.norm(AX, dim=0) + theta[:k]) * n * 10
        converged = int(torch.sum(resid_norms < tol * reltol))
        theta = theta[None, :k]
        i += 1
    return theta[0, :], X, i


def _check_inputs(A, X: torch.Tensor) -> None:
    n, k = X.shape
    if k == 0:
        raise ValueError(f"must have search dim > 0, got {k}")
    if k * 5 >= n:
        raise ValueError(f"expected search dim * 5 < matrix dim (got {k * 5}, {n})")
    test_output = A(torch.zeros((n, 1), dtype=X.dtype, device=X.device))
    if test_output.dtype != X.dtype:
        raise ValueError(f"A, X must have same dtypes (were {test_output.dtype}, {X.dtype})")
    if tuple(test_output.shape) != (n, 1):
        raise ValueError(f"A must be ({n}, {n}) matrix A, got output {tuple(test_output.shape)}")


def _eigh_descending(S: torch.Tensor):
    w, V = torch.linalg.eigh(S)
    return torch.flip(w, (0,)), torch.flip(V, (1,))


def _svqb(X: torch.Tensor) -> torch.Tensor:
    """An orthonormal basis of span(X) through the eigenbasis of X^T X;
    numerically dependent directions come out as zero columns."""
    norms = torch.linalg.norm(X, dim=0, keepdim=True)
    X = X / torch.where(norms == 0, torch.ones_like(norms), norms)

    inner = X.T @ X
    w, V = _eigh_descending(inner)

    # eigenvalues below max * eps are degenerate directions
    tau = torch.finfo(X.dtype).eps * w[0]
    padded = torch.maximum(w, tau)
    sqrted = torch.where(tau > 0, padded, torch.ones_like(padded)) ** (-0.5)

    orthoX = X @ (V * sqrted[None, :])

    keep = ((w > tau) & (torch.diagonal(inner) > 0.0))[None, :]
    orthoX = orthoX * keep.to(orthoX.dtype)
    norms = torch.linalg.norm(orthoX, dim=0, keepdim=True)
    keep = keep & (norms > 0.0)
    return orthoX / torch.where(keep, norms, torch.ones_like(norms))


def _project_out(basis: torch.Tensor, U: torch.Tensor) -> torch.Tensor:
    """U's component orthogonal to the orthonormal ``basis`` (zero columns
    allowed), orthonormalised; suspicious columns are zeroed so that
    [basis, U] stays zero-or-orthogonal."""
    for _ in range(2):
        U = U - basis @ (basis.T @ U)
        U = _orthonormalize(U)
    # end on a subtraction of the basis: near convergence, normalisation can
    # bring back (X, P) components by cancellation
    for _ in range(2):
        U = U - basis @ (basis.T @ U)
    normU = torch.linalg.norm(U, dim=0, keepdim=True)
    return U * (normU >= 0.99).to(U.dtype)


def _orthonormalize(basis: torch.Tensor) -> torch.Tensor:
    for _ in range(2):
        basis = _svqb(basis)
    return basis


def _rayleigh_ritz_orth(A, S: torch.Tensor):
    """Eigenpairs (descending) of A projected onto the orthonormal S."""
    return _eigh_descending(S.T @ A(S))


def _extend_basis(X: torch.Tensor, m: int) -> torch.Tensor:
    """``m`` orthonormal directions orthogonal to the orthonormal X (n, k),
    from a block Householder reflector (deterministic, no random basis)."""
    n, k = X.shape
    Xupper, Xlower = X[:k], X[k:]
    u, s, vt = torch.linalg.svd(Xupper)
    y = torch.cat([Xupper + u @ vt, Xlower], dim=0)
    other = torch.cat([torch.eye(m, dtype=X.dtype, device=X.device),
                       torch.zeros((n - k - m, m), dtype=X.dtype, device=X.device)], dim=0)
    w = y @ (vt.T * ((2 * (1 + s)) ** (-1 / 2))[None, :])
    h = -2 * torch.linalg.multi_dot([w, w[k:, :].T, other])
    h[k:] += other
    return h
