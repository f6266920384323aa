"""The port's slice as a whole — train, checkpoint/resume, predict, evaluate —
against the JAX driver on the CPU at a small size.

Bars (bench.py:59-60): z trajectory within 5e-3 (4-dp rounding flips, not a
divergence) and CV / test NLPD within 0.05. The trajectories of this
problem are sensitive to float32 rounding: with 50 rows from data seed 0
instead, one ulp of arccos in a few angles moves the first gradient by ~0.3
and the port leaves the JAX trajectory by 0.076 at iteration 3, while JAX's
own float32 path is ~0.04 from its float64-feature gradient.
"""

import contextlib
import io
import os
import re
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dqgp_tpu import driver as JD
from dqgp_tpu.data import split_data_numpy
from dqgp_tpu.models.circuits import build_circuit
from dqgp_tpu.models.gp.metrics import evaluate_predictions as jax_eval
from dqgp_tpu.models.gp.posterior import predict_quantum_gp as jax_predict
from dqgp_tpu.models.kernels import QuantumKernelSpec
from dqgp_tpu_torch import driver as TD
from dqgp_tpu_torch.convert import spec_from_jax
from dqgp_tpu_torch.models.gp.metrics import evaluate_predictions as torch_eval
from dqgp_tpu_torch.models.gp.posterior import predict_quantum_gp as torch_predict
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parent.parent
Z_TOL, NLPD_TOL = 5e-3, 0.05


def _quiet(fn, *a, **k):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*a, **k)


@pytest.fixture(scope="module")
def problem(tmp_path_factory):
    spec = QuantumKernelSpec(circuit=build_circuit("chebyshev", 3, 2, 1),
                             kernel_type="projected", outer_kernel="matern")
    rng = np.random.RandomState(0)
    X = rng.uniform(-0.99, 0.99, (60, 2))
    Y = np.sin(3 * X[:, 0]) * np.cos(2 * X[:, 1]) + 0.1 * rng.randn(60)
    X_test = rng.uniform(-0.99, 0.99, (20, 2))
    Y_test = np.sin(3 * X_test[:, 0]) * np.cos(2 * X_test[:, 1]) + 0.1 * rng.randn(20)
    splits = _quiet(split_data_numpy, X, Y, 2, "regional")   # 2 agents of 30
    ckdir = tmp_path_factory.mktemp("jax_ckpt")
    kw = dict(cv_folds=3, verbose=False)
    jax3 = JD.train(spec, splits, X, Y, JD.TrainConfig(
        max_iter=3, checkpoint_dir=str(ckdir), checkpoint_every=3, **kw))
    jax6 = JD.train(spec, splits, X, Y, JD.TrainConfig(max_iter=6, **kw))
    return dict(spec=spec, X=X, Y=Y, X_test=X_test, Y_test=Y_test, splits=splits,
                jax3=jax3, jax6=jax6, ckpt=str(ckdir / "ckpt_00003.npz"), kw=kw)


def _z_traj(res):
    return np.array([h["consensus_params"] for h in res.cv_history])


def _cv(res):
    return np.array([h["consensus_cv_score"] for h in res.cv_history])


def _compare(port, ref, rows=slice(None)):
    z_dev = float(np.abs(_z_traj(port) - _z_traj(ref)[rows]).max())
    cv_dev = float(np.abs(_cv(port) - _cv(ref)[rows]).max())
    print(f"z trajectory max dev {z_dev:.2e}, CV-NLPD max dev {cv_dev:.2e}")
    assert z_dev <= Z_TOL and cv_dev <= NLPD_TOL
    assert port.converged_by == ref.converged_by
    assert port.iterations == ref.iterations
    np.testing.assert_allclose(port.z, ref.z, rtol=0, atol=Z_TOL)


def test_train_predict_evaluate_match_jax(problem):
    p = problem
    port = TD.train(spec_from_jax(p["spec"]), p["splits"], p["X"], p["Y"],
                    TD.TrainConfig(max_iter=3, **p["kw"]), device="cpu")
    _compare(port, p["jax3"])
    assert len(port.nll_history) == 3 and all(h["solver"] == "float64" for h in port.cv_history)

    mj, vj = jax_predict(p["spec"], jnp.asarray(p["X"]), jnp.asarray(p["Y"]),
                         jnp.asarray(p["X_test"]), jnp.asarray(p["jax3"].z))
    mt, vt = torch_predict(spec_from_jax(p["spec"]), torch.as_tensor(p["X"]),
                           torch.as_tensor(p["Y"]), torch.as_tensor(p["X_test"]),
                           torch.as_tensor(port.z))
    ej = jax_eval(p["Y_test"], np.asarray(mj), np.asarray(vj))
    et = torch_eval(p["Y_test"], mt, vt)
    print(f"test NLPD port {et['nlpd']:.4f} vs JAX {ej['nlpd']:.4f}")
    assert np.isfinite(et["nlpd"]) and abs(et["nlpd"] - ej["nlpd"]) <= NLPD_TOL


def test_resume_from_jax_checkpoint(problem, tmp_path):
    p = problem
    port = TD.train(spec_from_jax(p["spec"]), p["splits"], p["X"], p["Y"],
                    TD.TrainConfig(max_iter=6, checkpoint_dir=str(tmp_path),
                                   checkpoint_every=2, **p["kw"]),
                    resume_from=p["ckpt"], device="cpu")
    # the port ran iterations 4-6 on JAX's state; compare with JAX's
    # uninterrupted 6-iteration run over those rows and its final z
    assert [h["iteration"] for h in port.cv_history] == [4, 5, 6]
    _compare(port, p["jax6"], rows=slice(3, 6))
    # the port's checkpoint is in the JAX layout: JAX's loader reads it
    ck = JD.load_checkpoint(str(tmp_path / "ckpt_00006.npz"))
    assert ck["iteration"] == 6
    np.testing.assert_array_equal(ck["theta"], port.theta)
    assert ck["cv_best"] == port.cv_best


def test_device_is_required():
    with pytest.raises(TypeError):
        TD.train(None, [], None, None, TD.TrainConfig())


def test_flagged_cv_fold_is_rescored_in_float64(problem, monkeypatch):
    # A fold whose factorization the fold batch flags (NaN) is re-scored
    # through the full fallback chain, as the JAX driver does
    # (driver.py:664-680), and the row says so.
    p = problem
    real = TD.cv_fold_scores_impl

    def flag_first_fold(*a, **k):
        nlpd, r2, rmse = real(*a, **k)
        nlpd = nlpd.clone()
        nlpd[0] = float("nan")
        return nlpd, r2, rmse

    monkeypatch.setattr(TD, "cv_fold_scores_impl", flag_first_fold)
    port = TD.train(spec_from_jax(p["spec"]), p["splits"], p["X"], p["Y"],
                    TD.TrainConfig(max_iter=2, **p["kw"]), device="cpu")
    assert [h["solver"] for h in port.cv_history] == ["float64-rescue"] * 2
    assert all(h["valid_folds"] == 3 for h in port.cv_history)
    np.testing.assert_allclose(_cv(port), _cv(p["jax3"])[:2], rtol=0, atol=NLPD_TOL)


def test_import_loads_no_jax_sklearn_matplotlib():
    code = ("import sys, dqgp_tpu_torch, dqgp_tpu_torch.driver, dqgp_tpu_torch.convert; "
            "bad = [m for m in ('jax', 'sklearn', 'matplotlib') if m in sys.modules]; "
            "sys.exit(1 if bad else 0)")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    assert subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO).returncode == 0


def test_no_jax_import_lines_in_the_port():
    pat = re.compile(r"^\s*(import jax|from jax)")
    offenders = [f"{f}:{i}" for f in sorted((REPO / "dqgp_tpu_torch").rglob("*.py"))
                 for i, line in enumerate(f.read_text().splitlines(), 1) if pat.match(line)]
    assert offenders == []


def test_every_port_test_file_takes_the_one_thread_rule():
    """tests/torch_threads.py holds the port's tests' one thread rule: every
    tests/test_torch_*.py imports its fixture, and no test file nor the
    package sets torch's thread count or defines a thread fixture itself."""
    rule = re.compile(r"^from torch_threads import one_torch_thread\b", re.M)
    sets = re.compile(r"\bset_num_(interop_)?threads\(")
    own = re.compile(r"@pytest\.fixture[^\n]*\n(?:@[^\n]*\n)*def \w*thread", re.M)
    files = sorted((REPO / "tests").glob("test_torch_*.py"))
    assert len(files) > 40
    missing = [f.name for f in files if not rule.search(f.read_text())]
    setting = [f.name for f in files + sorted((REPO / "dqgp_tpu_torch").rglob("*.py"))
               if sets.search(f.read_text())]
    fixtures = [f.name for f in files if own.search(f.read_text())]
    assert (missing, setting, fixtures) == ([], [], [])
