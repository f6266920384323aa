"""The port's driver modes against the JAX driver on the CPU: ``TrainConfig``
field for field, ``cond_mode`` (the float64 host backfill,
``host_condition_numbers``), ``chain_iters`` (chunked dispatch, mid-chunk
stops and checkpoints, the rescue of a flagged row), ``gp_dtype`` /
``cv_dtype`` "float32", and the fields the port refuses.

Problems are small (chebyshev 3 qubits / 1 layer, hubregtsen 2 qubits, 2-4
agents of 10-30 rows). Bars: the port against itself is exact (z, theta,
psi) and rtol 1e-12 (NLLs, CV scores); against JAX, z within 5e-3 and
CV-NLPD within 0.05 (bench.py:59-60: float32 features flip 4-dp roundings);
float64 condition numbers at rtol 1e-6 (both build the Gram from complex128
states; only the eigensolvers' rounding differs, ~cond * eps_f64).
"""

import contextlib
import dataclasses
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dqgp_tpu import driver as JD
from dqgp_tpu.data import generate_quantum_gp_data, split_data_numpy
from dqgp_tpu.models.circuits import build_circuit
from dqgp_tpu.models.kernels import QuantumKernelSpec
from dqgp_tpu.models.kernels.quantum_kernel import gram as jax_gram
from dqgp_tpu_torch import driver as TD
from dqgp_tpu_torch.convert import spec_from_jax
from dqgp_tpu_torch.models.gp import cv as TCV
from dqgp_tpu_torch.parallel import consensus as TC
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

Z_TOL, NLPD_TOL = 5e-3, 0.05


def _quiet(fn, *a, **k):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*a, **k)


def _hub_problem(n=24, seed=42):
    """tests/test_driver.py:16-25's problem."""
    spec = QuantumKernelSpec(circuit=build_circuit("hubregtsen", 2, 2, 1),
                             kernel_type="projected", outer_kernel="gaussian")
    X, Y, gt = generate_quantum_gp_data(n, 2, spec, data_range=(-0.95, 0.95),
                                        noise_std=0.05, data_seed=seed, param_seed=seed)
    return spec, np.asarray(X), np.asarray(Y), np.asarray(gt)


@pytest.fixture(scope="module")
def cheb():
    """chebyshev 3 qubits / 1 layer, Matérn, 2 regional agents of 30 rows,
    trained 7 iterations by JAX per iteration and chained (3 a chunk)."""
    spec = QuantumKernelSpec(circuit=build_circuit("chebyshev", 3, 2, 1),
                             kernel_type="projected", outer_kernel="matern")
    rng = np.random.RandomState(0)
    X = rng.uniform(-0.99, 0.99, (60, 2))
    Y = np.sin(3 * X[:, 0]) * np.cos(2 * X[:, 1]) + 0.1 * rng.randn(60)
    splits = _quiet(split_data_numpy, X, Y, 2, "regional")
    kw = dict(cv_folds=3, verbose=False, max_iter=7)
    jax_chained = JD.train(spec, splits, X, Y, JD.TrainConfig(chain_iters=3, **kw))
    return dict(spec=spec, tspec=spec_from_jax(spec), X=X, Y=Y, splits=splits, kw=kw,
                jax_chained=jax_chained)


def _z(res):
    return np.array([h["consensus_params"] for h in res.cv_history])


def _cv(res):
    return np.array([h["consensus_cv_score"] for h in res.cv_history])


def _assert_identical(a, b):
    """b's run is a's, bit for bit in the state, within rtol 1e-12 in the
    scores (the same torch ops on the same inputs)."""
    assert (b.iterations, b.converged_by) == (a.iterations, a.converged_by)
    for f in ("z", "theta", "psi", "z_best_cv"):
        np.testing.assert_array_equal(getattr(b, f), getattr(a, f), err_msg=f)
    np.testing.assert_array_equal(_z(b), _z(a))
    assert b.error_history == a.error_history
    np.testing.assert_allclose(_cv(b), _cv(a), rtol=1e-12)
    for ha, hb in zip(a.nll_history, b.nll_history):
        np.testing.assert_allclose(hb["agent_losses"], ha["agent_losses"], rtol=1e-12)


# --- TrainConfig ----------------------------------------------------------


def test_train_config_has_every_jax_field_with_its_default():
    jf = {f.name: f.default for f in dataclasses.fields(JD.TrainConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(TD.TrainConfig)}
    assert list(tf) == list(jf)
    assert tf == jf


@pytest.mark.parametrize("field,value", [("n_mesh_devices", 1), ("data_mesh_cols", 2),
                                         ("solve_2d", "distributed")])
def test_mesh_fields_take_only_their_defaults(cheb, field, value):
    cfg = TD.TrainConfig(max_iter=1, verbose=False, **{field: value})
    with pytest.raises(NotImplementedError, match="Queue 1 item 11"):
        TD.train(cheb["tspec"], cheb["splits"], cheb["X"], cheb["Y"], cfg, device="cpu")


@pytest.mark.parametrize("field", ["gp_dtype", "cv_dtype"])
def test_mixed_dtype_is_not_ported(cheb, field):
    cfg = TD.TrainConfig(max_iter=1, verbose=False, **{field: "mixed"})
    with pytest.raises(ValueError, match="not ported"):
        TD.train(cheb["tspec"], cheb["splits"], cheb["X"], cheb["Y"], cfg, device="cpu")


# --- cond_mode ------------------------------------------------------------


@pytest.mark.parametrize("mode,compute,device,want", [
    ("auto", True, "cpu", "device"), ("auto", True, "cuda", "host"),
    ("device", True, "cuda", "device"), ("host", True, "cpu", "host"),
    ("auto", False, "cpu", "off"), ("host", False, "cuda", "off"),
])
def test_cond_mode_resolution(mode, compute, device, want):
    cfg = TD.TrainConfig(cond_mode=mode, compute_cond=compute)
    assert TD.resolve_cond_mode(cfg, torch.device(device)) == want


@pytest.mark.parametrize("bad", ["Host", "gpu", "off"])
def test_cond_mode_rejects_unknown_values(cheb, bad):
    """As tests/test_driver.py:337-346: an unknown value raises before any
    work, whatever the device."""
    with pytest.raises(ValueError, match="cond_mode"):
        TD.train(cheb["tspec"], cheb["splits"], cheb["X"], cheb["Y"],
                 TD.TrainConfig(max_iter=1, verbose=False, cond_mode=bad), device="cpu")


def test_device_cond_with_chained_dispatch_on_cuda_is_refused(cheb):
    """eigvalsh reads its info on the host, which a CUDA graph cannot
    capture: refused at config time, before the device is touched."""
    with pytest.raises(ValueError, match="eigvalsh"):
        TD.train(cheb["tspec"], cheb["splits"], cheb["X"], cheb["Y"],
                 TD.TrainConfig(cond_mode="device", chain_iters=2), device="cuda")


def test_host_cond_chunk_boundary():
    """As tests/test_driver.py:241-273: T=18 crosses the 16-row chunk, and
    row 16 carries 3.1416 > pi, which must be wrapped as the step wraps it.
    Held to JAX's backfill and to a direct float64 cond per row."""
    spec, X, Y, _ = _hub_problem(n=24)
    splits = split_data_numpy(X, Y, 2, "sequential")
    Z = np.random.RandomState(3).uniform(0, np.pi, size=(18, spec.num_parameters)).round(4)
    Z[16, 0] = 3.1416
    got = TD.host_condition_numbers(spec_from_jax(spec), splits, Z, device="cpu")
    want = JD.host_condition_numbers(spec, splits, Z)
    assert got.shape == (18, 2) and np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    for t in (0, 15, 16, 17):
        for a, (X_i, _) in enumerate(splits):
            K = np.asarray(jax_gram(spec, jnp.asarray(X_i, jnp.float64),
                                    jnp.asarray(np.mod(Z[t], np.pi)), dtype=jnp.float64))
            w = np.abs(np.linalg.eigvalsh(K))
            np.testing.assert_allclose(got[t, a], w.max() / max(w.min(), np.finfo(float).tiny),
                                       rtol=1e-6)


def test_host_cond_resolves_beyond_the_float32_floor():
    """As tests/test_driver.py:276-311: near-duplicate rows make the true
    Gram nearly singular (eigenvalues ~1e-14 relative); the float64 backfill
    sees it, the float32-built Gram cannot."""
    spec = QuantumKernelSpec(circuit=build_circuit("hubregtsen", 2, 2, 1),
                             kernel_type="projected", outer_kernel="gaussian")
    rng = np.random.RandomState(0)
    X = np.repeat(rng.uniform(-0.9, 0.9, size=(6, 2)), 2, axis=0)
    X[1::2] += 1e-7
    Y = rng.standard_normal(len(X))
    theta = rng.uniform(0, np.pi, size=spec.num_parameters).round(4)
    got = float(TD.host_condition_numbers(spec_from_jax(spec), [(X, Y)], theta[None],
                                          device="cpu")[0, 0])
    want = float(JD.host_condition_numbers(spec, [(X, Y)], theta[None])[0, 0])
    K32 = np.asarray(jax_gram(spec, jnp.asarray(X, jnp.float32),
                              jnp.asarray(theta, jnp.float32)), np.float64)
    w32 = np.abs(np.linalg.eigvalsh(K32))
    floor = w32.max() / max(w32.min(), np.finfo(float).tiny)
    assert got > 1e11 and floor < 1e11 and got > 30 * floor, (got, floor)
    # lambda_min sits at float64 rounding level here, where two eigensolvers
    # differ: the reference's bucket (Good < 1e12 <= Moderate < 1e15 <= Poor)
    # is what must agree
    assert TD._cond_status(got, True) == TD._cond_status(want, True), (got, want)


def test_cond_modes_give_one_trajectory_and_host_values_match_jax(cheb):
    """cond is reporting only: "device", "host" and off train the same z;
    the host backfill equals JAX's host_condition_numbers at the same rows."""
    runs = {mode: TD.train(cheb["tspec"], cheb["splits"], cheb["X"], cheb["Y"],
                           TD.TrainConfig(**{**cheb["kw"], "max_iter": 3}, **kw), device="cpu")
            for mode, kw in (("device", dict(cond_mode="device")),
                             ("host", dict(cond_mode="host")),
                             ("off", dict(compute_cond=False)))}
    for mode in ("host", "off"):
        _assert_identical(runs["device"], runs[mode])
    host = np.array([h["condition_numbers"] for h in runs["host"].nll_history])
    np.testing.assert_allclose(host, JD.host_condition_numbers(cheb["spec"], cheb["splits"],
                                                               _z(runs["host"])), rtol=1e-6)
    assert np.all(np.isnan([h["condition_numbers"] for h in runs["off"].nll_history]))
    # the device values come from the f32-built Gram: f32 representation
    # noise on cond ~1e6 (tests/test_driver.py:234-236 allows 2 %)
    dev = np.array([h["condition_numbers"] for h in runs["device"].nll_history])
    np.testing.assert_allclose(dev, host, rtol=0.1)


def test_verbose_agents_prints_host_conds_and_buckets(cheb, capsys):
    res = TD.train(cheb["tspec"], cheb["splits"], cheb["X"], cheb["Y"],
                   TD.TrainConfig(**{**cheb["kw"], "max_iter": 2, "verbose": True},
                                  cond_mode="host", verbose_agents=True), device="cpu")
    out = capsys.readouterr().out
    host = JD.host_condition_numbers(cheb["spec"], cheb["splits"], _z(res))
    for it in range(2):
        for a in range(2):
            assert f"cond={host[it, a]:.2e} (Good)" in out
    assert out.count("Agent 1: NLL=") == 2


def test_device_cond_floor_warning_once_per_process(capsys, monkeypatch):
    monkeypatch.setattr(TD, "_warned_cond_floor", [])
    for mode, dev in (("device", "cpu"), ("host", "cuda"), ("off", "cuda")):
        TD._warn_device_cond_floor(mode, torch.device(dev))
    assert capsys.readouterr().out == ""
    TD._warn_device_cond_floor("device", torch.device("cuda"))
    TD._warn_device_cond_floor("device", torch.device("cuda"))
    out = capsys.readouterr().out
    assert out.count("saturate") == 1 and "not ported" not in out


# --- chain_iters ----------------------------------------------------------


def test_chained_matches_per_iteration_and_jax_chained(cheb):
    """As tests/test_driver.py:132-164: 7 iterations in chunks of 3 stop
    inside the third chunk and discard its speculative row."""
    p = cheb
    a = TD.train(p["tspec"], p["splits"], p["X"], p["Y"], TD.TrainConfig(**p["kw"]),
                 device="cpu")
    b = TD.train(p["tspec"], p["splits"], p["X"], p["Y"],
                 TD.TrainConfig(chain_iters=3, **p["kw"]), device="cpu")
    assert b.iterations == 7 and b.converged_by == "max_iter"
    _assert_identical(a, b)
    assert b.chain_stats["chain_iters"] == 3 and not b.chain_stats["captured"]
    j = p["jax_chained"]
    assert (b.iterations, b.converged_by) == (j.iterations, j.converged_by)
    assert np.abs(_z(b) - _z(j)).max() <= Z_TOL
    assert np.abs(_cv(b) - _cv(j)).max() <= NLPD_TOL
    np.testing.assert_allclose(b.z, j.z, rtol=0, atol=Z_TOL)


def test_chained_without_cv_and_mid_chunk_checkpoints(tmp_path):
    """As tests/test_driver.py:168-191: iteration 3 lies inside the first
    chunk of 4; its checkpoint carries that iteration's state, and a resume
    from it reproduces the uninterrupted run."""
    spec, X, Y, _ = _hub_problem(n=32)
    tspec = spec_from_jax(spec)
    splits = split_data_numpy(X, Y, 2, "sequential")
    base = dict(rho=100.0, L=100.0, noise_std=0.05, seed=42, compute_cond=False,
                verbose=False, run_cv=False, max_iter=6)
    a = TD.train(tspec, splits, X, Y, TD.TrainConfig(**base), device="cpu")
    b = TD.train(tspec, splits, X, Y, TD.TrainConfig(chain_iters=4, checkpoint_dir=str(tmp_path),
                                                     checkpoint_every=3, **base), device="cpu")
    _assert_identical(a, b)
    ck = TD.load_checkpoint(str(tmp_path / "ckpt_00003.npz"))
    assert ck["iteration"] == 3 and ck["theta"].shape == (2, spec.num_parameters)
    resumed = TD.train(tspec, splits, X, Y, TD.TrainConfig(**base),
                       resume_from=str(tmp_path / "ckpt_00003.npz"), device="cpu")
    np.testing.assert_array_equal(resumed.z, a.z)
    np.testing.assert_array_equal(resumed.theta, a.theta)
    # the JAX driver reads the port's mid-chunk checkpoint and continues it
    j = JD.train(spec, splits, X, Y, JD.TrainConfig(**base),
                 resume_from=str(tmp_path / "ckpt_00003.npz"))
    np.testing.assert_allclose(j.z, a.z, rtol=0, atol=Z_TOL)


@pytest.mark.parametrize("flag_at", [1, 2, 5])
def test_chained_rescue_reruns_a_flagged_row(cheb, monkeypatch, flag_at):
    """A row whose agent NLL the chunk's (flag) step leaves non-finite is
    re-run with the eigh-pinv fallback from its pre-row state, and chunking
    restarts from there: the trajectory is the per-iteration loop's. The
    flag is forced on the ``flag_at``-th call of the chunk's step (call 1 is
    the first chunk's first row: no warm-up runs on the CPU)."""
    p = cheb
    real = TC.make_admm_step

    def make_step(spec, **kw):
        step = real(spec, **kw)
        if kw["psd_fallback"]:
            return step
        calls = [0]

        def flagged(theta, psi, batch):
            out = step(theta, psi, batch)
            calls[0] += 1
            if calls[0] == flag_at:
                nan = torch.full_like(out.nll, float("nan"))
                out = out._replace(nll=nan, theta=out.theta * float("nan"))
            return out
        return flagged

    monkeypatch.setattr(TD, "make_admm_step", make_step)
    a = TD.train(p["tspec"], p["splits"], p["X"], p["Y"], TD.TrainConfig(**p["kw"]),
                 device="cpu")
    b = TD.train(p["tspec"], p["splits"], p["X"], p["Y"],
                 TD.TrainConfig(chain_iters=3, **p["kw"]), device="cpu")
    _assert_identical(a, b)
    solvers = [h["solver"] for h in b.nll_history]
    assert solvers.count("float64-rescue") == 1
    assert solvers.index("float64-rescue") == flag_at - 1


# --- gp_dtype / cv_dtype ----------------------------------------------------


def test_float32_gp_and_cv_dtypes_match_jax(cheb):
    p = cheb
    kw = dict(p["kw"], max_iter=3, gp_dtype="float32", cv_dtype="float32")
    j = JD.train(p["spec"], p["splits"], p["X"], p["Y"], JD.TrainConfig(**kw))
    t = TD.train(p["tspec"], p["splits"], p["X"], p["Y"], TD.TrainConfig(**kw), device="cpu")
    assert [h["solver"] for h in t.nll_history] == ["float32"] * 3
    assert [h["solver"] for h in t.cv_history] == [h["solver"] for h in j.cv_history]
    assert np.abs(_z(t) - _z(j)).max() <= Z_TOL
    assert np.abs(_cv(t) - _cv(j)).max() <= NLPD_TOL
    # float32 NLLs of float32 Grams: the two engines' last-ulp differences
    # through a float32 solve
    for ht, hj in zip(t.nll_history[:1], j.nll_history[:1]):
        np.testing.assert_allclose(ht["agent_losses"], hj["agent_losses"], rtol=1e-3)


def test_float32_cv_scores_match_jax_at_one_z(cheb):
    """The float32 fold pass itself at one z and one fold split."""
    from dqgp_tpu.models.gp import cv as JCV

    p = cheb
    z = _z(p["jax_chained"])[2]
    want = JCV._cv_fold_scores(p["spec"], jnp.asarray(p["X"]), jnp.asarray(p["Y"]),
                               jnp.asarray(z), *JCV.kfold_pad_indices(60, 3, 7),
                               cv_dtype="float32")
    got = TCV.cv_fold_scores_impl(p["tspec"], torch.as_tensor(p["X"]), torch.as_tensor(p["Y"]),
                                  torch.as_tensor(z), *TCV.kfold_pad_indices(60, 3, 7, "cpu"),
                                  cv_dtype="float32")
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-3, atol=2e-3)


def test_fold_buffers_hold_the_fold_indices():
    n, k = 23, 4
    buf = TCV.FoldIndexBuffers(n, k, 3, "cpu")
    buf.fill([5, 6, 7])
    for row, seed in enumerate((5, 6, 7)):
        for got, want in zip(buf.folds(row), TCV.kfold_pad_indices(n, k, seed, "cpu")):
            np.testing.assert_array_equal(got.numpy(), want.numpy())
    buf.fill([9])  # a shorter fill leaves the later rows as they were
    np.testing.assert_array_equal(buf.folds(0)[0].numpy(),
                                  TCV.kfold_pad_indices(n, k, 9, "cpu")[0].numpy())
    np.testing.assert_array_equal(buf.folds(2)[2].numpy(),
                                  TCV.kfold_pad_indices(n, k, 7, "cpu")[2].numpy())
