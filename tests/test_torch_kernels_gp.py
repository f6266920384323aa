"""Kernel layer, GP linear algebra, posterior, NLL and CV of the port vs the
JAX package, fed the same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dqgp_tpu.models.circuits import build_circuit
from dqgp_tpu.models.gp import cv as JCV
from dqgp_tpu.models.gp import posterior as JP
from dqgp_tpu.models.gp.metrics import evaluate_predictions as jax_eval
from dqgp_tpu.models.kernels import QuantumKernelSpec as JaxSpec
from dqgp_tpu.models.kernels import outer as JO
from dqgp_tpu.models.kernels import quantum_kernel as JQ
from dqgp_tpu.ops import linalg as JL
from dqgp_tpu_torch.convert import spec_from_jax
from dqgp_tpu_torch.models.gp import cv as TCV
from dqgp_tpu_torch.models.gp import posterior as TP
from dqgp_tpu_torch.models.gp.metrics import evaluate_predictions as torch_eval
from dqgp_tpu_torch.models.kernels import outer as TO
from dqgp_tpu_torch.models.kernels import quantum_kernel as TQ
from dqgp_tpu_torch.ops import linalg as TL
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

OUTER_CASES = [
    ("gaussian", {}), ("gaussian", {"gamma": 0.3}), ("matern", {}),
    ("matern", {"nu": 0.5}), ("matern", {"nu": 2.5, "length_scale": 0.7}),
    ("matern", {"nu": float("inf")}), ("expsinesquared", {}),
    ("rationalquadratic", {"alpha": 2.0}), ("dotproduct", {}),
    ("pairwisekernel", {}), ("pairwisekernel", {"metric": "rbf", "gamma": 0.5}),
    ("pairwisekernel", {"metric": "poly", "gamma": 0.5}),
]


def _t(a):
    return torch.tensor(np.asarray(a))


@pytest.mark.parametrize("name,params", OUTER_CASES)
def test_outer_kernels_f64(name, params):
    rng = np.random.RandomState(0)
    FA, FB = rng.uniform(-1, 1, (9, 6)), rng.uniform(-1, 1, (7, 6))
    want = np.asarray(JO.outer_gram(name, jnp.asarray(FA), jnp.asarray(FB), params))
    got = TO.outer_gram(name, _t(FA), _t(FB), params).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("kernel_type,reg", [("projected", None), ("fidelity", None),
                                             ("projected", "thresholding"),
                                             ("fidelity", "tikhonov")])
def test_gram_from_features_f64(kernel_type, reg):
    c = build_circuit("hubregtsen", 3, 2, 1)
    spec = JaxSpec(circuit=c, kernel_type=kernel_type, outer_kernel="matern",
                   regularization=reg)
    rng = np.random.RandomState(1)
    X = rng.uniform(-0.9, 0.9, (8, 2))
    th = rng.uniform(0, np.pi, c.num_parameters)
    FA = JQ.kernel_features(spec, jnp.asarray(X), jnp.asarray(th), jnp.float64)
    want = np.asarray(JQ.gram_from_features(spec, FA))
    got = TQ.gram_from_features(spec_from_jax(spec), _t(FA)).numpy()
    # eigh-based regularizers go through two LAPACK eigensolvers
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 if reg is None else 1e-10)
    # the f64 complex128 feature path on the CPU
    Ft = TQ.kernel_features(spec_from_jax(spec), _t(X), _t(th), torch.float64)
    np.testing.assert_allclose(Ft.numpy(), np.asarray(FA), rtol=0, atol=1e-12)


def test_gram_and_shift_grads_f32():
    c = build_circuit("chebyshev", 3, 2, 1)
    spec = JaxSpec(circuit=c, kernel_type="projected", outer_kernel="matern")
    rng = np.random.RandomState(2)
    X = rng.uniform(-0.9, 0.9, (11, 2)).astype(np.float32)
    th = rng.uniform(0, np.pi, c.num_parameters).astype(np.float32)
    Kj, dKj = JQ.gram_and_shift_grads(spec, jnp.asarray(X), jnp.asarray(th))
    Kt, dKt = TQ.gram_and_shift_grads(spec_from_jax(spec), _t(X), _t(th))
    assert Kt.dtype == dKt.dtype == torch.float32
    assert dKt.shape == (c.num_parameters, 11, 11)
    # float32 features and Grams through two engines
    np.testing.assert_allclose(Kt.numpy(), np.asarray(Kj), rtol=0, atol=2e-5)
    np.testing.assert_allclose(dKt.numpy(), np.asarray(dKj), rtol=0, atol=2e-5)
    # a leading agents dimension shares theta and equals per-agent calls
    X2 = np.stack([X, X[::-1]])
    Kb, dKb = TQ.gram_and_shift_grads(spec_from_jax(spec), _t(X2), _t(th))
    np.testing.assert_array_equal(Kb[0].numpy(), Kt.numpy())
    np.testing.assert_array_equal(dKb[0].numpy(), dKt.numpy())
    np.testing.assert_allclose(Kb[1].numpy(), Kt.numpy()[::-1, ::-1], rtol=0, atol=1e-6)


def test_shift_parameter_batch_is_f32_and_wrapped():
    th = np.array([0.1, 3.0, 1.5], np.float32)
    got = TQ.shift_parameter_batch(_t(th), float(np.pi / 8))
    want = np.asarray(JQ.shift_parameter_batch(jnp.asarray(th), float(np.pi / 8)))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def _gp_inputs(seed=3, n=12, P=5, n_real=9):
    rng = np.random.RandomState(seed)
    F = rng.uniform(-1, 1, (n, 4))
    K = np.asarray(JO.outer_gram("matern", jnp.asarray(F), jnp.asarray(F)))
    dK = rng.randn(P, n, n) * 0.1
    dK = 0.5 * (dK + dK.transpose(0, 2, 1))
    y = rng.randn(n)
    mask = (np.arange(n) < n_real).astype(np.float64)
    return K, dK, y, mask


def test_masked_nll_and_grad_same_inputs():
    K, dK, y, mask = _gp_inputs()
    want = JP.masked_nll_and_grad(jnp.asarray(K), jnp.asarray(dK), jnp.asarray(y),
                                  jnp.asarray(mask), 0.1)
    got = TP.masked_nll_and_grad(_t(K), _t(dK), _t(y), _t(mask), 0.1)
    for f in ("nll", "grad", "log_det_term", "quadratic_term", "constant_term"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   rtol=1e-10, err_msg=f)
    # condition numbers: two f64 eigensolvers
    np.testing.assert_allclose(got.condition_number.numpy(),
                               np.asarray(want.condition_number), rtol=1e-8)
    assert bool(got.chol_ok)
    # agents as a leading batch dimension
    Kb, dKb = np.stack([K, K * 0.9 + 0.1 * np.eye(12)]), np.stack([dK, -dK])
    gb = TP.masked_nll_and_grad(_t(Kb), _t(dKb), _t(np.stack([y, y])),
                                _t(np.stack([mask, mask])), 0.1)
    np.testing.assert_allclose(gb.nll[0].numpy(), got.nll.numpy(), rtol=1e-12)
    np.testing.assert_allclose(gb.grad[0].numpy(), got.grad.numpy(), rtol=1e-12)


def test_posterior_from_grams_same_inputs():
    rng = np.random.RandomState(4)
    F = rng.uniform(-1, 1, (10, 4))
    Fs = rng.uniform(-1, 1, (6, 4))
    K = np.asarray(JO.outer_gram("gaussian", jnp.asarray(F), jnp.asarray(F)))
    Ks = np.asarray(JO.outer_gram("gaussian", jnp.asarray(Fs), jnp.asarray(F)))
    y = rng.randn(10)
    m = (np.arange(10) < 8).astype(np.float64)
    for mask in (None, m):
        jm = None if mask is None else jnp.asarray(mask)
        tm = None if mask is None else _t(mask)
        for solver in ("direct", "direct-flag"):
            mj, vj, _ = JP.gp_posterior_from_grams(
                jnp.asarray(K), jnp.asarray(Ks), jnp.ones(6), jnp.asarray(y), 0.1,
                train_mask=jm, solver=solver)
            mt, vt, ok = TP.gp_posterior_from_grams(_t(K), _t(Ks), torch.ones(6, dtype=torch.float64),
                                                    _t(y), 0.1, train_mask=tm, solver=solver)
            np.testing.assert_allclose(mt.numpy(), np.asarray(mj), rtol=1e-10)
            np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=1e-10)
            assert bool(ok)


def test_cholesky_failure_rescue_matches_jax():
    rng = np.random.RandomState(5)
    A = rng.randn(8, 8)
    C = A @ A.T - 2.0 * np.eye(8) * np.abs(np.linalg.eigvalsh(A @ A.T)).max() * 0.05
    assert np.linalg.eigvalsh(C).min() < 0  # indefinite
    y = rng.randn(8)
    want = JL.solve_psd_with_fallback(jnp.asarray(C), jnp.asarray(y))
    got = TL.solve_psd_with_fallback(_t(C), _t(y))
    assert not bool(got.chol_ok) and not bool(want.chol_ok)
    # both rescue through a float32 eigh: two LAPACK eigensolvers in f32
    scale = np.abs(np.asarray(want.C_inv)).max()
    np.testing.assert_allclose(got.C_inv.numpy(), np.asarray(want.C_inv), rtol=0, atol=1e-4 * scale)
    np.testing.assert_allclose(got.logdet.numpy(), np.asarray(want.logdet), rtol=1e-5)
    # flag semantics: NaN outputs, chol_ok False
    flagged = TL.get_psd_solver("direct-flag")(_t(C), _t(y))
    assert not bool(flagged.chol_ok) and bool(torch.isnan(flagged.C_inv_y).all())
    # batched: only the failed member is rescued, the healthy one is untouched
    good = A @ A.T + np.eye(8)
    both = TL.solve_psd_with_fallback(_t(np.stack([good, C])), _t(np.stack([y, y])))
    single = TL.solve_psd_with_fallback(_t(good), _t(y))
    assert both.chol_ok.tolist() == [True, False]
    np.testing.assert_array_equal(both.C_inv_y[0].numpy(), single.C_inv_y.numpy())
    np.testing.assert_allclose(both.C_inv_y[1].numpy(), got.C_inv_y.numpy(), rtol=1e-12)


def test_linalg_helpers():
    K, _, _, mask = _gp_inputs()
    np.testing.assert_array_equal(TL.masked_identity_pad(_t(K), _t(mask)).numpy(),
                                  np.asarray(JL.masked_identity_pad(jnp.asarray(K), jnp.asarray(mask))))
    C = K + 0.01 * np.eye(12)
    np.testing.assert_allclose(TL.condition_number(_t(C)).numpy(),
                               np.asarray(JL.condition_number(jnp.asarray(C), "eigh")), rtol=1e-8)
    with pytest.raises(NotImplementedError, match="mixed"):
        TL.get_psd_solver("mixed")


@pytest.mark.parametrize("n,k,seed", [(10, 3, 0), (25, 5, 42), (7, 7, 3), (1000, 5, 47), (101, 4, 9)])
def test_kfold_indices_equal_sklearn(n, k, seed):
    want = JCV.kfold_pad_indices_np(n, k, seed)  # sklearn KFold(shuffle=True)
    got = TCV.kfold_pad_indices_np(n, k, seed)
    for w, g in zip(want, got):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_kfold_rejects_infeasible_folds():
    with pytest.raises(ValueError):
        TCV.kfold_pad_indices_np(3, 5, 0)
    with pytest.raises(ValueError):
        TCV.kfold_pad_indices_np(10, 1, 0)


def _small_problem():
    c = build_circuit("chebyshev", 3, 2, 1)
    spec = JaxSpec(circuit=c, kernel_type="projected", outer_kernel="matern")
    rng = np.random.RandomState(6)
    X = rng.uniform(-0.99, 0.99, (40, 2))
    Y = np.sin(3 * X[:, 0]) * np.cos(2 * X[:, 1]) + 0.1 * rng.randn(40)
    th = np.round(rng.uniform(0, np.pi, c.num_parameters), 4)
    return spec, X, Y, th


def test_cv_fold_scores_match_jax():
    spec, X, Y, th = _small_problem()
    folds = JCV.kfold_pad_indices(40, 5, 7)
    want = JCV._cv_fold_scores(spec, jnp.asarray(X), jnp.asarray(Y), jnp.asarray(th),
                               *folds, noise_std=0.1)
    got = TCV.cv_fold_scores_impl(spec_from_jax(spec), _t(X), _t(Y), _t(th),
                                  *TCV.kfold_pad_indices(40, 5, 7, "cpu"), noise_std=0.1)
    # float32 features from two engines feed float64 fold solves
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4)
    agg_t = TCV.aggregate_cv_scores(*got, 5)
    agg_j = JCV.aggregate_cv_scores(*want, 5)
    assert agg_t["valid_folds"] == agg_j["valid_folds"] == 5
    assert abs(agg_t["mean_nlpd"] - agg_j["mean_nlpd"]) < 1e-4
    full = TCV.k_fold_cross_validation_consensus(spec_from_jax(spec), _t(X), _t(Y), th, 0.1,
                                                 k_folds=5, random_seed=7)
    assert full["mean_nlpd"] == agg_t["mean_nlpd"]
    rescued = TCV.k_fold_cross_validation_consensus(spec_from_jax(spec), _t(X), _t(Y), th, 0.1,
                                                    k_folds=5, random_seed=7, rescue=True)
    assert abs(rescued["mean_nlpd"] - agg_t["mean_nlpd"]) < 1e-12


def test_aggregate_cv_failure_semantics():
    nl, r2, rm = [0.5, np.nan, 0.7, np.inf], [0.9, 0.1, 0.8, 0.2], [0.1, 0.2, 0.3, 0.4]
    assert TCV.aggregate_cv_scores(nl, r2, rm, 4) == JCV.aggregate_cv_scores(nl, r2, rm, 4)
    nl = [np.nan, np.nan, np.nan, 0.3]
    assert TCV.aggregate_cv_scores(nl, r2, rm, 4) == JCV.aggregate_cv_scores(nl, r2, rm, 4)


def test_predict_and_evaluate_match_jax():
    spec, X, Y, th = _small_problem()
    Xs = np.random.RandomState(8).uniform(-0.99, 0.99, (15, 2))
    Ys = np.sin(3 * Xs[:, 0]) * np.cos(2 * Xs[:, 1])
    mj, vj = JP.predict_quantum_gp(spec, jnp.asarray(X), jnp.asarray(Y), jnp.asarray(Xs),
                                   jnp.asarray(th), noise_std=0.1)
    mt, vt = TP.predict_quantum_gp(spec_from_jax(spec), _t(X), _t(Y), _t(Xs), _t(th),
                                   noise_std=0.1)
    assert mt.dtype == vt.dtype == torch.float64
    # float32 features from two engines, float64 posterior
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), rtol=0, atol=1e-4)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=1e-3, atol=1e-7)
    et, ej = torch_eval(Ys, mt, vt), jax_eval(Ys, np.asarray(mj), np.asarray(vj))
    assert et.keys() == ej.keys()
    assert abs(et["nlpd"] - ej["nlpd"]) < 1e-3 and abs(et["r2"] - ej["r2"]) < 1e-4


def test_quantum_kernel_facade():
    c = build_circuit("hubregtsen", 3, 2, 1)
    qk = TQ.create_quantum_kernel(3, 2, 1, encoding_type="hubregtsen",
                                  kernel_type="projected", outer_kernel="matern",
                                  device="cpu")
    rng = np.random.RandomState(9)
    X = rng.uniform(-0.9, 0.9, (6, 2))
    th = rng.uniform(0, np.pi, c.num_parameters)
    qk.assign_parameters(th)
    jspec = JaxSpec(circuit=c, kernel_type="projected", outer_kernel="matern")
    want = np.asarray(JQ.gram(jspec, jnp.asarray(X), jnp.asarray(th), dtype=jnp.float64))
    np.testing.assert_allclose(qk.evaluate(X), want, rtol=0, atol=1e-12)
    d = qk.evaluate_derivatives(X)
    assert d["K"].shape == (6, 6) and d["dKdp"].shape == (c.num_parameters, 6, 6)
    with pytest.raises(NotImplementedError):
        qk.evaluate_derivatives(X, X[::-1])
