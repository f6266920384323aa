"""The matrix-free CG posterior (parallel/blocked.py) against the JAX
package's on the CPU in float64, at tests/test_blocked.py's sizes and bars:
the blocked Gram matvec against the dense product, CG on an SPD system,
the pivoted-Cholesky factor and the Woodbury preconditioner, the posterior
(mean rtol 1e-4 / atol 1e-6, variance rtol 1e-3 / atol 1e-6, CG iteration
counts equal) and the CG predictor, with and without square-Gram
regularization (the low-rank eigenvalue clip), against both JAX's and the
port's dense posterior.

Where both sides start from the same float64 features, the two CG loops run
the same arithmetic up to the order of the matvec's sums, and with a
pivoted-Cholesky preconditioner they stop at the same iteration. Jacobi CG
converges slowly enough here (~40-60 iterations) that those rounding
differences move its residual curve by up to a factor 2 near the stopping
threshold, and its count by 1 to 3 (measured at cg_tol 1e-6 to 1e-10); its
bar is 3. The predictor computes its own float32 features on each side
(torch's plain engine vs XLA's), so there the bars are the posterior's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dqgp_tpu.models.circuits import build_circuit
from dqgp_tpu.models.kernels import QuantumKernelSpec as JaxSpec
from dqgp_tpu.models.kernels.quantum_kernel import gram_from_features, kernel_features
from dqgp_tpu.parallel import blocked as JB
from dqgp_tpu_torch.convert import spec_from_jax
from dqgp_tpu_torch.models.gp.posterior import predict_quantum_gp
from dqgp_tpu_torch.parallel import blocked as TB
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

MEAN = dict(rtol=1e-4, atol=1e-6)
VAR = dict(rtol=1e-3, atol=1e-6)


def _setup(kernel_type="projected", N=70, seed=0, outer="gaussian"):
    """tests/test_blocked.py:15-25, plus float64 features as numpy."""
    jspec = JaxSpec(circuit=build_circuit("hubregtsen", 3, 2, 1),
                    kernel_type=kernel_type, outer_kernel=outer)
    rng = np.random.RandomState(seed)
    X = jnp.asarray(rng.uniform(-0.9, 0.9, (N, 2)), jnp.float32)
    theta = jnp.asarray(rng.uniform(0, np.pi, jspec.num_parameters), jnp.float32)
    F = np.asarray(kernel_features(jspec, X, theta))
    F = F.astype(np.complex128 if kernel_type == "fidelity" else np.float64)
    Y = np.sin(np.asarray(X)[:, 0]) + 0.05 * rng.randn(N)
    return jspec, spec_from_jax(jspec), F, Y


@pytest.mark.parametrize("kernel_type", ["projected", "fidelity"])
def test_gram_matvec_matches_dense_and_jax(kernel_type):
    jspec, spec, F, _ = _setup(kernel_type)
    v = np.random.RandomState(1).randn(F.shape[0], 3)
    mask = np.ones(F.shape[0])
    got = TB.gram_matvec(spec, torch.tensor(F), torch.tensor(v), torch.tensor(mask), block=32)
    want = np.asarray(JB.gram_matvec(jspec, jnp.asarray(F), jnp.asarray(v),
                                     jnp.asarray(mask), block=32))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)
    dense = np.asarray(gram_from_features(jspec, jnp.asarray(F), jnp.asarray(F))) @ v
    np.testing.assert_allclose(got.numpy(), dense, rtol=1e-5, atol=1e-6)
    # a masked row neither contributes nor receives
    mask[5] = 0.0
    got = TB.gram_matvec(spec, torch.tensor(F), torch.tensor(v), torch.tensor(mask), block=32)
    assert float(got[5].abs().max()) == 0.0


def test_cg_solve_matches_jax():
    rng = np.random.RandomState(2)
    A = rng.randn(40, 12)
    Mat = A @ A.T + 40 * np.eye(40)
    b = rng.randn(40, 2)
    got = TB.cg_solve(lambda v: torch.tensor(Mat) @ v, torch.tensor(b), tol=1e-10,
                      maxiter=200, diag_precond=torch.tensor(np.diag(Mat)))
    want = JB.cg_solve(lambda v: jnp.asarray(Mat) @ v, jnp.asarray(b), tol=1e-10,
                       maxiter=200, diag_precond=jnp.asarray(np.diag(Mat)))
    np.testing.assert_allclose(got.x.numpy(), np.linalg.solve(Mat, b), rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=1e-10, atol=1e-12)
    assert got.iterations == int(want.iterations)
    assert got.residual_norm == pytest.approx(float(want.residual_norm), rel=1e-6)
    # maxiter caps the loop; no preconditioner is the identity
    capped = TB.cg_solve(lambda v: torch.tensor(Mat) @ v, torch.tensor(b), tol=1e-14, maxiter=3)
    assert capped.iterations == 3 and capped.residual_norm > 1e-14


def test_pivoted_cholesky_and_woodbury_match_jax():
    jspec, spec, F, Y = _setup(N=60, seed=9)
    L = TB.pivoted_cholesky(spec, torch.tensor(F), rank=40)
    want = np.asarray(JB.pivoted_cholesky(jspec, jnp.asarray(F), rank=40))
    assert L.dtype == torch.float64
    np.testing.assert_allclose(L.numpy(), want, rtol=1e-8, atol=1e-10)
    K = np.asarray(gram_from_features(jspec, jnp.asarray(F), jnp.asarray(F)))
    assert np.linalg.norm(K - L.numpy().T @ L.numpy()) / np.linalg.norm(K) < 1e-5
    r = np.random.RandomState(3).randn(60, 2)
    got = TB.woodbury_preconditioner(L, 0.01)(torch.tensor(r))
    want_w = JB.woodbury_preconditioner(jnp.asarray(want), 0.01)(jnp.asarray(r))
    np.testing.assert_allclose(got.numpy(), np.asarray(want_w), rtol=1e-8, atol=1e-10)
    exact = np.linalg.solve(0.01 * np.eye(60) + L.numpy().T @ L.numpy(), r)
    np.testing.assert_allclose(got.numpy(), exact, rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("precond_rank", [16, 0])
def test_gp_posterior_large_matches_jax(precond_rank):
    jspec, spec, F, Y = _setup(N=90)
    args = (F[:80], Y[:80], F[80:])
    kw = dict(noise_std=0.1, block=32, cg_tol=1e-10, cg_maxiter=400,
              precond_rank=precond_rank)
    mean, var, res = TB.gp_posterior_large(spec, *map(torch.tensor, args), **kw)
    jm, jv, jres = JB.gp_posterior_large(jspec, *map(jnp.asarray, args), **kw)
    np.testing.assert_allclose(mean.numpy(), np.asarray(jm), **MEAN)
    np.testing.assert_allclose(var.numpy(), np.asarray(jv), **VAR)
    assert res.iterations < 400 and res.residual_norm <= 1e-10
    if precond_rank:
        assert res.iterations == int(jres.iterations)
    else:
        assert abs(res.iterations - int(jres.iterations)) <= 3


@pytest.mark.parametrize("kernel_type,outer,n_tr,n_te", [
    ("projected", "matern", 160, 600),   # > test_chunk: exercises chunking
    ("fidelity", "gaussian", 96, 24),
])
def test_cg_predictor_matches_jax_and_dense(kernel_type, outer, n_tr, n_te):
    """tests/test_blocked.py:136-194: the CG route against the dense
    posterior, here also against the JAX package's CG route."""
    jspec = JaxSpec(circuit=build_circuit("hubregtsen" if kernel_type == "projected"
                                          else "yz_cx", 3, 2, 1),
                    kernel_type=kernel_type, outer_kernel=outer)
    spec = spec_from_jax(jspec)
    rng = np.random.RandomState(0 if kernel_type == "projected" else 1)
    Xtr = rng.uniform(-0.9, 0.9, (n_tr, 2))
    Ytr = np.sin(3 * Xtr[:, 0]) + 0.1 * rng.randn(n_tr)
    Xte = rng.uniform(-0.9, 0.9, (n_te, 2))
    theta = rng.uniform(0, np.pi, spec.num_parameters)
    kw = dict(cg_tol=1e-8, cg_maxiter=600)
    predict = TB.make_cg_predictor(spec, Xtr, Ytr, theta, 0.1, device="cpu", **kw)
    m_c, v_c = predict(Xte)
    jpredict = JB.make_cg_predictor(jspec, Xtr, Ytr, theta, 0.1, **kw)
    jm, jv = jpredict(Xte)
    assert m_c.dtype == torch.float64 and m_c.shape == (n_te,)
    np.testing.assert_allclose(m_c.numpy(), np.asarray(jm), **MEAN)
    np.testing.assert_allclose(v_c.numpy(), np.asarray(jv), **VAR)
    assert predict.alpha_result.residual_norm <= 30 * 1e-8
    assert len(predict.variance_results) == -(-n_te // 512)
    m_d, v_d = predict_quantum_gp(spec, torch.tensor(Xtr), torch.tensor(Ytr),
                                  torch.tensor(Xte), torch.tensor(theta), noise_std=0.1)
    np.testing.assert_allclose(m_c.numpy(), m_d.numpy(), **MEAN)
    np.testing.assert_allclose(v_c.numpy(), v_d.numpy(), **VAR)
    m_1, v_1 = TB.predict_quantum_gp_large(spec, Xtr, Ytr, Xte, theta, 0.1, device="cpu",
                                          **kw)
    np.testing.assert_array_equal(m_1.numpy(), m_c.numpy())


def test_cg_predictor_warns_when_not_converged():
    _, spec, _, _ = _setup()
    rng = np.random.RandomState(4)
    X, Y = rng.uniform(-0.9, 0.9, (40, 2)), rng.randn(40)
    theta = rng.uniform(0, np.pi, spec.num_parameters)
    with pytest.warns(RuntimeWarning, match="alpha solve did not converge"):
        predict = TB.make_cg_predictor(spec, X, Y, theta, 0.1, cg_maxiter=1, precond_rank=0,
                                       device="cpu")
    with pytest.warns(RuntimeWarning, match="variance solve did not converge"):
        predict(X[:5])


@pytest.mark.parametrize("method,precond_rank", [("thresholding", 64), ("tikhonov", 0)])
def test_regularized_cg_predictor_matches_jax_and_dense(method, precond_rank):
    """tests/test_blocked.py:236-259: make_cg_predictor with
    ``spec.regularization`` applies the low-rank eigenvalue clip to the CG's
    matvec (and, under Jacobi, its diagonal); it matches JAX's CG route and
    the port's dense posterior, whose square Gram goes through
    regularize_gram."""
    jspec = JaxSpec(circuit=build_circuit("hubregtsen", 3, 2, 1), kernel_type="projected",
                    outer_kernel="matern", regularization=method)
    spec = spec_from_jax(jspec)
    rng = np.random.RandomState(2)
    Xtr = rng.uniform(-0.9, 0.9, (128, 2))
    Ytr = np.sin(3 * Xtr[:, 0]) + 0.1 * rng.randn(128)
    Xte = rng.uniform(-0.9, 0.9, (24, 2))
    theta = rng.uniform(0, np.pi, spec.num_parameters)
    kw = dict(cg_tol=1e-8, cg_maxiter=400, precond_rank=precond_rank)
    m_c, v_c = TB.make_cg_predictor(spec, Xtr, Ytr, theta, 0.1, device="cpu", **kw)(Xte)
    jm, jv = JB.make_cg_predictor(jspec, Xtr, Ytr, theta, 0.1, **kw)(Xte)
    np.testing.assert_allclose(m_c.numpy(), np.asarray(jm), **MEAN)
    np.testing.assert_allclose(v_c.numpy(), np.asarray(jv), **VAR)
    m_d, v_d = predict_quantum_gp(spec, torch.tensor(Xtr), torch.tensor(Ytr),
                                  torch.tensor(Xte), torch.tensor(theta), noise_std=0.1)
    np.testing.assert_allclose(m_c.numpy(), m_d.numpy(), **MEAN)
    np.testing.assert_allclose(v_c.numpy(), v_d.numpy(), **VAR)


@pytest.mark.parametrize("entry", ["make_cg_predictor", "predict_quantum_gp_large"])
def test_cg_predictor_runs_on_the_card_unless_asked_for_the_cpu(entry):
    """Leaving out ``device`` asks for the card: where there is no CUDA
    device both entry points raise instead of computing on the CPU; where
    there is one, the posterior lies on it."""
    _, spec, _, _ = _setup()
    rng = np.random.RandomState(5)
    X, Y = rng.uniform(-0.9, 0.9, (20, 2)), rng.randn(20)
    theta = rng.uniform(0, np.pi, spec.num_parameters)

    def run():
        if entry == "make_cg_predictor":
            return TB.make_cg_predictor(spec, X, Y, theta, 0.1)(X[:3])
        return TB.predict_quantum_gp_large(spec, X, Y, X[:3], theta, 0.1)

    if torch.cuda.is_available():
        mean, var = run()
        assert mean.device.type == var.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run()
