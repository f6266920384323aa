"""The low-rank eigenvalue clip (parallel/blocked.py: LowRankRegularizer,
make_lowrank_regularizer_from_matvec, make_lowrank_regularizer) and its
matrix-free LOBPCG (ops/lobpcg.py) against the JAX package on the CPU in
float64, on the same seeded numpy inputs.

The two eigensolvers return bases of the captured eigenspace that differ in
sign and rotation, so regularizers are compared by their action: the
regularized matvec on random vectors, the diagonal correction, lambda_min,
the shift and ``saturated``. Bars:

* the clip against the dense ``regularize_gram`` (eigh) on a synthetic
  indefinite matrix (``chip_smoke.indefinite_matrix``, phase 18a's):
  rtol 1e-6 / atol 1e-8, lambda_min rtol 1e-5
  (tests/test_blocked.py:224-233); the port's clip against JAX's at the
  same bars;
* on a float64 feature Gram (the north star's circuit, 200 rows), whose
  spectrum has no negative part, the clip is a no-op on both sides; its
  lambda_min is LOBPCG's unconverged Ritz value, held within 1e-6 of
  lambda_max of eigvalsh's and of JAX's;
* LOBPCG's top-k against torch.linalg.eigh: eigenvalues rtol 1e-10
  (float64), the eigenvectors' subspace within 1e-6.
"""

from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.sparse.linalg import lobpcg_standard as jax_lobpcg

import chip_smoke as cs
from dqgp_tpu.models.circuits import build_circuit
from dqgp_tpu.models.kernels import QuantumKernelSpec as JaxSpec
from dqgp_tpu.models.kernels.quantum_kernel import kernel_features
from dqgp_tpu.parallel import blocked as JB
from dqgp_tpu_torch.convert import spec_from_jax
from dqgp_tpu_torch.models.kernels.quantum_kernel import gram_from_features, regularize_gram
from dqgp_tpu_torch.ops.lobpcg import lobpcg_standard
from dqgp_tpu_torch.parallel import blocked as TB

CLIP = dict(rtol=1e-6, atol=1e-8)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """torch on one thread: LOBPCG's many small ops under the suite's
    workers otherwise spend their time in the thread pool's barriers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def both_clips(A: np.ndarray, method: str, rank: int):
    At, Aj = torch.tensor(A), jnp.asarray(A)
    reg = TB.make_lowrank_regularizer_from_matvec(lambda v: At @ v, A.shape[0], method,
                                                  rank=rank, dtype=torch.float64, device="cpu")
    jreg = JB.make_lowrank_regularizer_from_matvec(lambda v: Aj @ v, A.shape[0], method,
                                                   rank=rank, dtype=jnp.float64)
    return reg, jreg


def hold_actions(reg, jreg, A: np.ndarray, v: np.ndarray, **bars):
    """The port's regularizer against JAX's by their action."""
    got = reg.matvec(torch.tensor(A @ v), torch.tensor(v)).numpy()
    want = np.asarray(jreg.matvec(jnp.asarray(A @ v), jnp.asarray(v)))
    np.testing.assert_allclose(got, want, **bars)
    np.testing.assert_allclose(reg.diag_correction().numpy(),
                               np.asarray(jreg.diag_correction()), **bars)
    np.testing.assert_allclose(float(reg.shift), float(jreg.shift), **bars)
    assert bool(reg.saturated) == bool(jreg.saturated)


@pytest.mark.parametrize("method", ["thresholding", "tikhonov"])
def test_clip_matches_dense_and_jax_on_indefinite_matrix(method):
    A = cs.indefinite_matrix(64)
    reg, jreg = both_clips(A, method, rank=8)
    dense = regularize_gram(torch.tensor(A), method).numpy()
    v = np.random.RandomState(0).randn(64, 3)
    np.testing.assert_allclose(reg.matvec(torch.tensor(A @ v), torch.tensor(v)).numpy(),
                               dense @ v, **CLIP)
    np.testing.assert_allclose(np.diag(A) + reg.diag_correction().numpy(), np.diag(dense),
                               **CLIP)
    # a vector (N,) right-hand side as well as (N, R)
    v0 = v[:, 0]
    np.testing.assert_allclose(reg.matvec(torch.tensor(A @ v0), torch.tensor(v0)).numpy(),
                               dense @ v0, **CLIP)
    assert not bool(reg.saturated)  # 8 >> 2 negatives
    np.testing.assert_allclose(float(reg.lambda_min), -0.8, rtol=1e-5)
    assert reg.V.shape == (64, 8) and reg.V.dtype == torch.float64
    hold_actions(reg, jreg, A, v, **CLIP)
    np.testing.assert_allclose(float(reg.lambda_min), float(jreg.lambda_min), rtol=1e-5)


@pytest.mark.parametrize("rank", [1, 2])
def test_clip_is_saturated_when_the_rank_is_short(rank):
    """Every captured pair negative: the budget may have missed further
    negatives. At rank 2 both negatives are captured and the clip is still
    exact, at rank 1 only the most negative one."""
    A = cs.indefinite_matrix(64)
    reg, jreg = both_clips(A, "thresholding", rank=rank)
    assert bool(reg.saturated) and bool(jreg.saturated)
    assert int(torch.count_nonzero(reg.w)) == rank
    v = np.random.RandomState(1).randn(64, 2)
    hold_actions(reg, jreg, A, v, **CLIP)
    dense = regularize_gram(torch.tensor(A), "thresholding").numpy()
    err = np.abs(reg.matvec(torch.tensor(A @ v), torch.tensor(v)).numpy() - dense @ v).max()
    assert (err < 1e-8) == (rank == 2)


@pytest.mark.parametrize("n", [80, 81])
def test_rank_clamp_raises_where_the_reference_raises(n):
    """rank = min(rank, n // 5); LOBPCG needs 5 * rank < n, so n = 80 (and
    every multiple of 5 up to 80) raises on both sides, n = 81 runs."""
    A = cs.indefinite_matrix(n)
    if n == 80:
        At, Aj = torch.tensor(A), jnp.asarray(A)
        with pytest.raises(ValueError, match=r"search dim \* 5 < matrix dim \(got 80, 80\)"):
            TB.make_lowrank_regularizer_from_matvec(lambda v: At @ v, n, "tikhonov",
                                                    dtype=torch.float64, device="cpu")
        with pytest.raises(ValueError, match=r"search dim \* 5 < matrix dim \(got 80, 80\)"):
            JB.make_lowrank_regularizer_from_matvec(lambda v: Aj @ v, n, "tikhonov",
                                                    dtype=jnp.float64)
        return
    reg, jreg = both_clips(A, "tikhonov", rank=16)
    assert reg.V.shape == (81, 16)
    hold_actions(reg, jreg, A, np.random.RandomState(2).randn(n, 2), **CLIP)
    np.testing.assert_allclose(float(reg.lambda_min), -0.8, rtol=1e-5)


def test_unknown_method_raises():
    with pytest.raises(ValueError, match="Unknown regularization"):
        TB.make_lowrank_regularizer_from_matvec(lambda v: v, 100, "clip", device="cpu")


def test_clip_on_a_feature_gram_is_a_no_op_like_jax():
    """make_lowrank_regularizer on the north star's float64 feature Gram (200
    rows, the same features on both sides): no negative eigenvalue on
    either side, so w = 0 and shift = 0. After LOBPCG's 200 iterations
    lambda_min is a Ritz value short of convergence, above eigvalsh's by
    ~1.6e-8 of lambda_max here (1.6e-7 at 400 rows) on both sides: each is
    held within 1e-6 of lambda_max of eigvalsh and of the other."""
    jspec = JaxSpec(circuit=build_circuit("chebyshev", 4, 2, 3), kernel_type="projected",
                    outer_kernel="matern", regularization="thresholding")
    spec = spec_from_jax(jspec)
    rng = np.random.RandomState(0)
    X = jnp.asarray(rng.uniform(-0.99, 0.99, (200, 2)), jnp.float32)
    theta = jnp.asarray(rng.uniform(0, np.pi, jspec.num_parameters), jnp.float32)
    F = np.asarray(kernel_features(jspec, X, theta), np.float64)
    reg = TB.make_lowrank_regularizer(spec, torch.tensor(F), dtype=torch.float64)
    jreg = JB.make_lowrank_regularizer(jspec, jnp.asarray(F), dtype=jnp.float64)
    assert int(torch.count_nonzero(reg.w)) == 0 and float(reg.shift) == 0.0
    assert not bool(reg.saturated) and not bool(jreg.saturated)
    ev = torch.linalg.eigvalsh(gram_from_features(replace(spec, regularization=None),
                                                  torch.tensor(F)))
    lam_true, bar = float(ev[0]), 1e-6 * float(ev[-1])
    assert lam_true > 0
    for lam in (float(reg.lambda_min), float(jreg.lambda_min)):
        assert lam_true <= lam <= lam_true + bar
    assert abs(float(reg.lambda_min) - float(jreg.lambda_min)) <= bar
    v = torch.tensor(rng.randn(200, 2))
    np.testing.assert_array_equal(reg.matvec(torch.zeros_like(v), v).numpy(), 0.0)


@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-10), (torch.float32, 1e-5)])
def test_lobpcg_top_k_matches_eigh_and_jax(dtype, rtol):
    rng = np.random.RandomState(3)
    n, k = 200, 8
    Q, _ = np.linalg.qr(rng.randn(n, n))
    w = np.linspace(0.1, 5.0, n)
    A = (Q * w) @ Q.T
    A = (A + A.T) / 2
    X0 = rng.randn(n, k)
    At = torch.tensor(A, dtype=dtype)
    theta, U, iters = lobpcg_standard(lambda v: At @ v, torch.tensor(X0, dtype=dtype), m=200)
    assert theta.shape == (k,) and U.shape == (n, k) and U.dtype == dtype and 0 < iters <= 200
    ew, ev = torch.linalg.eigh(torch.tensor(A))
    np.testing.assert_allclose(theta.double().numpy(), ew.flip(0)[:k].numpy(), rtol=rtol)
    # the captured subspace: U^T V_top has singular values 1
    s = torch.linalg.svdvals(U.double().T @ ev.flip(1)[:, :k])
    np.testing.assert_allclose(s.numpy(), 1.0, atol=1e-6 if dtype == torch.float64 else 1e-3)
    np.testing.assert_allclose((U.T @ U).double().numpy(), np.eye(k), atol=10 * rtol)
    jd = jnp.float64 if dtype == torch.float64 else jnp.float32
    jtheta, _, _ = jax_lobpcg(lambda v: jnp.asarray(A, jd) @ v, jnp.asarray(X0, jd), m=200)
    np.testing.assert_allclose(theta.double().numpy(), np.asarray(jtheta, np.float64), rtol=rtol)


def test_lobpcg_input_checks_match_jax():
    A = torch.eye(40, dtype=torch.float64)
    with pytest.raises(ValueError, match="search dim > 0"):
        lobpcg_standard(lambda v: A @ v, torch.zeros((40, 0), dtype=torch.float64))
    with pytest.raises(ValueError, match="same dtypes"):
        lobpcg_standard(lambda v: (A @ v).float(), torch.ones((40, 2), dtype=torch.float64))
    with pytest.raises(ValueError, match=r"must be \(40, 40\) matrix"):
        lobpcg_standard(lambda v: torch.cat([v, v]), torch.ones((40, 2), dtype=torch.float64))
