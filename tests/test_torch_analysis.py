"""The port's reporting (``dqgp_tpu_torch/utils/analysis.py`` and
``utils/plotting.py``) against the JAX package's.

* ``nll_error_correlation`` and ``compare_gt_vs_trained`` equal to JAX's on
  the same histories and metrics; ``post_training_report``'s text equal to
  JAX's on the same ``TrainResult``, from a port run and from synthetic
  histories that reach every branch.
* Every plotting function writes the file JAX's writes (name for name);
  without matplotlib each raises an ``ImportError`` naming ``--no-plot``.
* The new modules import neither JAX, nor the JAX package, nor sklearn, nor
  (until a plot is drawn) matplotlib.
"""

import contextlib
import functools
import io
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from dqgp_tpu.utils import analysis as JA
from dqgp_tpu_torch import driver as TD
from dqgp_tpu_torch.data import split_data_numpy
from dqgp_tpu_torch.models.circuits import build_circuit
from dqgp_tpu_torch.models.kernels import QuantumKernelSpec
from dqgp_tpu_torch.utils import analysis as TA
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]


def _histories(iters, agents, seed, gaps=False):
    """Synthetic nll/cv/error histories shaped as the driver records them;
    ``gaps`` puts non-finite values where the driver can record them."""
    rng = np.random.RandomState(seed)
    nll, cv, err = [], [], []
    for it in range(1, iters + 1):
        comps = [{"log_det_term": float(rng.normal(-50, 5)),
                  "quadratic_term": float(rng.uniform(10, 90)),
                  "constant_term": 41.35, "total": 0.0} for _ in range(agents)]
        if gaps and it % 3 == 0:
            comps[0]["quadratic_term"] = float("inf")
        losses = [c["log_det_term"] + c["quadratic_term"] + c["constant_term"] for c in comps]
        avg = float("inf") if gaps and it == 2 else float(np.mean(losses))
        nll.append({"iteration": it, "iter_time": float(rng.uniform(0.01, 2.0)),
                    "agent_losses": losses, "nll_components": comps,
                    "avg_nll": avg, "min_nll": float(min(losses)),
                    "max_nll": float(max(losses)), "total_nll": float(sum(losses))})
        score = float("inf") if gaps and it == 1 else float(rng.uniform(0.5, 3.0))
        cv.append({"iteration": it, "consensus_cv_score": score,
                   "cv_score_std": float(rng.uniform(0, 0.3)), "cv_r2": float(rng.uniform())})
        err.append(float(np.round(rng.uniform(0.5, 4.0), 4)))
    return nll, cv, err


@pytest.mark.parametrize("iters,gaps", [(0, False), (2, False), (5, True), (12, False),
                                        (12, True)])
def test_nll_error_correlation_matches_jax(iters, gaps):
    nll, _, err = _histories(iters, 3, iters, gaps)
    got, want = TA.nll_error_correlation(nll, err), JA.nll_error_correlation(nll, err)
    np.testing.assert_equal(got, want)


@pytest.mark.parametrize("seed", range(4))
def test_compare_gt_vs_trained_matches_jax(seed):
    rng = np.random.RandomState(seed)
    keys = ("mse", "rmse", "mae", "r2", "max_error", "nlpd", "normalized_rmse_range",
            "within_1sigma", "within_2sigma")
    trained = {k: float(rng.uniform(0.1, 2.0)) for k in keys}
    gt = {k: v * float(rng.choice([1.0, 1.005, 1.05, 1.3, 3.0, 0.5])) for k, v in trained.items()}
    gt.pop(keys[seed])
    assert TA.compare_gt_vs_trained(trained, gt) == JA.compare_gt_vs_trained(trained, gt)


def _report(module, res, gt):
    lines = []
    module.post_training_report(res, log=lambda *a: lines.append(" ".join(map(str, a))),
                                ground_truth_params=gt)
    return "\n".join(lines)


@pytest.fixture(scope="module")
def port_run():
    """A port training run (chebyshev 2 qubits, 2 agents, 4 iterations) with
    a ground truth."""
    rng = np.random.RandomState(5)
    X = rng.uniform(-1, 1, (48, 1))
    Y = np.sin(3 * X[:, 0]) + 0.1 * rng.randn(48)
    spec = QuantumKernelSpec(circuit=build_circuit("chebyshev", 2, 1, 1),
                             kernel_type="projected", outer_kernel="matern")
    with contextlib.redirect_stdout(io.StringIO()):
        splits = split_data_numpy(X, Y, 2, "regional")
    gt = np.round(rng.uniform(0, np.pi, spec.num_parameters), 4)
    res = TD.train(spec, splits, X, Y, TD.TrainConfig(max_iter=4, cv_folds=3, verbose=False),
                   ground_truth_params=gt, device="cpu")
    return res, gt


@pytest.mark.parametrize("with_gt", [True, False])
def test_post_training_report_text_matches_jax_on_a_port_run(port_run, with_gt):
    res, gt = port_run
    gt = gt if with_gt else None
    text = _report(TA, res, gt)
    assert text == _report(JA, res, gt)
    assert "FINAL HYPERPARAMETERS SUMMARY" in text
    assert ("NLL LOSS vs HYPERPARAMETER ERROR COMPARISON" in text) == with_gt


@pytest.mark.parametrize("iters,gaps,z_best_cv", [(0, False, False), (1, False, True),
                                                  (8, True, True), (12, False, False)])
def test_post_training_report_text_matches_jax_on_synthetic_histories(iters, gaps, z_best_cv):
    nll, cv, err = _histories(iters, 3, 100 + iters, gaps)
    rng = np.random.RandomState(iters)
    P = 4
    res = TD.TrainResult(
        z=rng.uniform(0, np.pi, P), z_best_cv=rng.uniform(0, np.pi, P) if z_best_cv else None,
        cv_best=min([h["consensus_cv_score"] for h in cv], default=float("inf")),
        theta=rng.uniform(0, np.pi, (3, P)), psi=rng.uniform(0, 1, (3, P)),
        iterations=iters, converged_by="max_iter", nll_history=nll, cv_history=cv,
        error_history=err, z_best_gt=rng.uniform(0, np.pi, P), error_best=min(err, default=0.0),
        total_time=1.25 * iters)
    gt = rng.uniform(0, np.pi, P)
    for g in (gt, None):
        assert _report(TA, res, g) == _report(JA, res, g)


PLOTS = {
    # name: (call on the plotting module, the files it writes)
    "dataset_1d": (lambda P, d, o: P.plot_dataset(d["X1"], d["Y"], output_dir=o),
                   ["dataset.png"]),
    "dataset_2d_split": (lambda P, d, o: P.plot_dataset(
        d["X2"], d["Y"], output_dir=o, train_indices=d["tr"], test_indices=d["te"]),
        ["dataset.png"]),
    "dataset_3d": (lambda P, d, o: P.plot_dataset(d["X3"], d["Y"], output_dir=o),
                   ["dataset.png"]),
    "agents_1d": (lambda P, d, o: P.plot_agent_data_distribution(d["splits1"], output_dir=o),
                  ["agent_distribution.png"]),
    "agents_2d": (lambda P, d, o: P.plot_agent_data_distribution(d["splits2"], output_dir=o),
                  ["agent_distribution.png", "agent_distribution_analysis.png"]),
    "agents_3d": (lambda P, d, o: P.plot_agent_data_distribution(d["splits3"], output_dir=o),
                  ["agent_distribution.png"]),
    "predictions_1d": (lambda P, d, o: P.plot_predictions(
        d["X1"], d["Y"], d["Y"] * 0.9, d["var"], d["X1"], d["Y"], output_dir=o,
        config={"encoding": "yz_cx"}, nlpd_info={"nlpd": 0.5}), ["predictions.png"]),
    "predictions_2d_gt": (lambda P, d, o: P.plot_predictions(
        d["X2"], d["Y"], d["Y"] * 0.9, d["var"], output_dir=o,
        filename="predictions_ground_truth.png"), ["predictions_ground_truth.png"]),
    "predictions_3d": (lambda P, d, o: P.plot_predictions(d["X3"], d["Y"], d["Y"] * 0.9,
                                                          output_dir=o), ["predictions.png"]),
    "srtm_2d": (lambda P, d, o: P.plot_real_world_dataset(
        d["X2"], d["Y"], "srtm_elevation", region="maharashtra", output_dir=o),
        ["srtm_elevation_maharashtra_40pts.png"]),
    "sst_2d": (lambda P, d, o: P.plot_real_world_dataset(d["X2"], d["Y"], "sst", output_dir=o),
               ["sst_40pts.png"]),
    "robot_3d": (lambda P, d, o: P.plot_real_world_dataset(d["X3"], d["Y"], "robot_push",
                                                           output_dir=o),
                 ["robot_push_40pts_3D.png"]),
    "robot_4d": (lambda P, d, o: P.plot_real_world_dataset(d["X4"], d["Y"], "robot_push",
                                                           output_dir=o),
                 ["robot_push_40pts_4D.png"]),
    "convergence": (lambda P, d, o: P.plot_convergence(d["nll"], d["cv"], d["err"],
                                                       output_dir=o), ["convergence.png"]),
}


@pytest.fixture(scope="module")
def plot_data():
    rng = np.random.RandomState(0)
    n = 40
    X = {f"X{k}": rng.uniform(-1, 1, (n, k)) for k in (1, 2, 3, 4)}
    Y = rng.normal(size=n)
    nll, cv, err = _histories(4, 2, 0)
    data = dict(X, Y=Y, var=rng.uniform(0.01, 0.1, n), tr=np.arange(30), te=np.arange(30, n),
                nll=nll, cv=cv, err=err)
    for k in (1, 2, 3):
        with contextlib.redirect_stdout(io.StringIO()):
            data[f"splits{k}"] = split_data_numpy(X[f"X{k}"], Y, 4, "regional")
    return data


@pytest.mark.parametrize("plot", sorted(PLOTS))
def test_plot_writes_the_jax_packages_files(plot, plot_data, tmp_path, monkeypatch):
    pytest.importorskip("matplotlib")
    from dqgp_tpu.utils import plotting as JP
    from dqgp_tpu_torch.utils import plotting as TP

    call, files = PLOTS[plot]
    written = {}
    for name, module in (("port", TP), ("jax", JP)):
        # the figures' content is the same code; a low dpi keeps them cheap
        monkeypatch.setattr(module, "_save", functools.partial(module._save, dpi=20))
        out = str(tmp_path / name)
        path = call(module, plot_data, out)
        assert os.path.basename(path) == files[0]
        written[name] = sorted(os.listdir(out))
        assert all(os.path.getsize(os.path.join(out, f)) > 0 for f in written[name])
    assert written["port"] == written["jax"] == sorted(files)


@pytest.mark.parametrize("plot", ["dataset_1d", "convergence"])
def test_plots_without_matplotlib_raise_naming_no_plot(plot, plot_data, tmp_path, monkeypatch):
    from dqgp_tpu_torch.utils import plotting as TP

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setitem(sys.modules, "matplotlib.pyplot", None)
    with pytest.raises(ImportError, match="--no-plot"):
        PLOTS[plot][0](TP, plot_data, str(tmp_path))
    assert not os.path.exists(tmp_path / PLOTS[plot][1][0])


NEW_MODULES = ("dqgp_tpu_torch.cli", "dqgp_tpu_torch.data.real_world",
               "dqgp_tpu_torch.models.gp.noise", "dqgp_tpu_torch.utils.analysis",
               "dqgp_tpu_torch.utils.plotting")


@pytest.mark.parametrize("module", NEW_MODULES)
def test_module_imports_no_jax_sklearn_matplotlib(module):
    code = (f"import sys, {module}; "
            "bad = [m for m in ('jax', 'dqgp_tpu', 'sklearn', 'matplotlib') if m in sys.modules]; "
            "print(bad); sys.exit(1 if bad else 0)")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.mark.parametrize("module", NEW_MODULES)
def test_module_source_names_no_jax_package(module):
    """No import of JAX, the JAX package or sklearn anywhere in the source;
    matplotlib only inside a function."""
    path = REPO / (module.replace(".", "/") + ".py")
    anywhere = re.compile(r"^\s*(import|from)\s+(jax|dqgp_tpu|sklearn)\b(?!_torch)")
    top_level = re.compile(r"^(import|from)\s+matplotlib\b")
    assert [line for line in path.read_text().splitlines()
            if anywhere.match(line) or top_level.match(line)] == []
