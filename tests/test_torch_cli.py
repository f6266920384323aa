"""The port's CLI (``dqgp_tpu_torch.cli``) against the JAX package's
(``dqgp_tpu.cli``) on the CPU.

* The flag inventory: every flag of the JAX CLI with the same type, choices,
  default and action, plus ``--device`` (default "cuda").
* Small runs, each through both CLIs on the same flags (``--device cpu`` for
  the port): quantum-dataset projected, classical fidelity, ``--fit-noise
  --predictive-noise``, an SRTM run on a stand-in tile (200 rows, 2 agents,
  2 iterations), ``--dataset-only --save-dataset``. Bars: the summary's
  keys equal; z within 5e-3 and CV-NLPD and test NLPD within 0.05
  (bench.py:59-60: float32 features flip 4-dp roundings); the fitted sigma
  within rtol 1e-3.
* Flags that reach what the port does not have raise; ``--device cuda``
  without a card raises.
* The fixture of ``chip_smoke.py`` phase 17 (tests/fixtures/torch_port_cli.json,
  the JAX CLI on the card's flags, scripts/record_torch_port_cli.py) at its
  full size, through the bars phase 17 holds the card to; and run A with
  the JAX package's float32 Grams in the step (tests/test_torch_gate_engines.py's
  seam), which follows JAX's run exactly: the SRTM trajectory's fork is the
  float32 Gram's, not the port's.
"""

import contextlib
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import chip_smoke as cs
from dqgp_tpu import cli as J
from dqgp_tpu_torch import cli as T
from scripts.make_synthetic_tiles import write_tile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def one_torch_thread():
    """torch on one thread: the plain engines' many small ops on a host
    that the other test workers load too spend their time in the thread
    pool's barriers (a full-size run takes minutes instead of seconds);
    the results hold on either."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

SMALL = ["--n-agents", "2", "--max-iter", "2", "--cv-folds", "3", "--no-plot", "--quiet"]
RUNS = {
    "quantum_projected": ["--input-dim", "2", "--n-dataset", "60", "--encoding", "hubregtsen",
                          "--kernel-type", "projected", "--num-qubits", "2", "--num-layers", "1",
                          "--outer-kernel", "matern", "--data-seed", "1"],
    "classical_fidelity": ["--classical-dataset", "--input-dim", "1", "--n-dataset", "30",
                           "--num-qubits", "2", "--num-layers", "1", "--encoding", "yz_cx",
                           "--kernel-type", "fidelity", "--data-seed", "2"],
    "fit_noise": ["--input-dim", "1", "--n-dataset", "80", "--encoding", "hubregtsen",
                  "--kernel-type", "projected", "--num-qubits", "2", "--num-layers", "1",
                  "--outer-kernel", "matern", "--data-seed", "21", "--noise-std", "0.1",
                  "--generating-noise-std", "0.5", "--fit-noise", "--predictive-noise"],
    # the README's SRTM circuit and kernel (BASELINE config #2) at 200 rows
    "srtm": ["--real-world-dataset", "srtm", "--srtm-region", "maharashtra",
             "--dataset-max-samples", "200", "--dataset-normalize", "--encoding", "chebyshev",
             "--kernel-type", "projected", "--num-qubits", "4", "--num-layers", "3",
             "--outer-kernel", "matern"],
}


def _actions(parser):
    return {a.option_strings[0]: a for a in parser._actions if a.option_strings}


def test_flag_inventory_is_the_jax_clis_plus_device():
    jax_flags, port_flags = _actions(J.build_parser()), _actions(T.build_parser())
    assert set(port_flags) == set(jax_flags) | {"--device"}
    for flag, want in jax_flags.items():
        got = port_flags[flag]
        for attr in ("dest", "type", "choices", "default", "nargs", "const", "required"):
            assert getattr(got, attr) == getattr(want, attr), (flag, attr)
        assert type(got) is type(want), flag
    device = port_flags["--device"]
    assert device.default == "cuda" and device.type is str


@pytest.mark.parametrize("entry", ["dqgp_tpu_torch.cli", "dqgp_tpu_torch"])
def test_module_entry_points_list_every_flag(entry):
    out = subprocess.run([sys.executable, "-m", entry, "--help"], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    for flag in set(_actions(J.build_parser())) | {"--device"}:
        assert flag in out.stdout, flag


def _srtm_tile(directory):
    """The maharashtra stand-in tile in ``directory``/srtm_data."""
    os.makedirs(os.path.join(directory, "srtm_data"), exist_ok=True)
    write_tile("N17E073", os.path.join(directory, "srtm_data"))


def _trajectory(summary):
    return (np.array([h["consensus_params"] for h in summary["cv_history"]]),
            np.array([h["consensus_cv_score"] for h in summary["cv_history"]]))


@pytest.mark.parametrize("run", sorted(RUNS))
def test_port_cli_matches_jax_cli(run, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    if run == "srtm":
        _srtm_tile(str(tmp_path))
    flags = RUNS[run] + SMALL
    want = J.main(flags)
    got = T.main(flags + ["--device", "cpu"])
    assert set(got) == set(want)
    assert set(got["config"]) == set(want["config"]) | {"device"}
    assert (got["iterations"], got["converged_by"]) == (want["iterations"], want["converged_by"])
    z, cv = _trajectory(got)
    z_ref, cv_ref = _trajectory(want)
    assert np.abs(z - z_ref).max() <= cs.Z_TOL
    assert np.abs(cv - cv_ref).max() <= cs.NLPD_TOL
    assert abs(got["test_metrics"]["nlpd"] - want["test_metrics"]["nlpd"]) <= cs.NLPD_TOL
    assert set(got["test_metrics"]) == set(want["test_metrics"])
    assert (got["gt_metrics"] is None) == (want["gt_metrics"] is None)
    if run == "fit_noise":
        assert got["noise_fit"]["fit_samples"] == want["noise_fit"]["fit_samples"]
        np.testing.assert_allclose(got["noise_fit"]["fitted_noise_std"],
                                   want["noise_fit"]["fitted_noise_std"], rtol=cs.SIGMA_RTOL)
        assert got["eval_noise_std"] == got["noise_fit"]["fitted_noise_std"]
    else:
        assert got["noise_fit"] is want["noise_fit"] is None


def test_dataset_only_and_save_write_the_jax_clis_file(tmp_path, monkeypatch):
    flags = ["--input-dim", "1", "--n-dataset", "20", "--num-qubits", "2", "--num-layers", "1",
             "--dataset-only", "--save-dataset", "--dataset-name", "tiny", "--no-plot",
             "--data-seed", "3", "--quiet"]
    files = {}
    for name, main, extra in (("jax", J.main, []), ("port", T.main, ["--device", "cpu"])):
        os.makedirs(tmp_path / name)
        monkeypatch.chdir(tmp_path / name)
        assert main(flags + extra) is None
        files[name] = str(tmp_path / name / "quantum_datasets" / "tiny_1d_20.csv")
    with open(files["jax"]) as fj, open(files["port"]) as fp:
        assert fj.readline() == fp.readline() == "X1,Y\n"
    a, b = (np.loadtxt(files[n], delimiter=",", skiprows=1) for n in ("jax", "port"))
    np.testing.assert_array_equal(a[:, 0], b[:, 0])
    np.testing.assert_allclose(a[:, 1], b[:, 1], rtol=0, atol=1e-12)


def test_metrics_json_and_profile_dir(tmp_path):
    metrics, trace_dir = str(tmp_path / "m" / "run.json"), str(tmp_path / "trace")
    summary, stages = T.run(RUNS["quantum_projected"] + SMALL + [
        "--device", "cpu", "--metrics-json", metrics, "--profile-dir", trace_dir])
    with open(metrics) as f:
        assert json.load(f)["cv_best_nlpd"] == summary["cv_best_nlpd"]
    assert os.path.getsize(os.path.join(trace_dir, "train_trace.json")) > 0
    assert set(stages) == {"load", "split", "train", "backfill", "predict_test",
                           "predict_train", "predict_ground_truth", "report"}
    assert all(v >= 0.0 for v in stages.values())


def test_device_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        T.main(RUNS["quantum_projected"] + SMALL)


BASE = ["--input-dim", "1", "--n-dataset", "24", "--num-qubits", "2", "--num-layers", "1",
        "--kernel-type", "projected", "--max-iter", "1", "--no-plot", "--quiet",
        "--data-seed", "4", "--device", "cpu"]


@pytest.mark.parametrize("extra,error", [
    (["--mesh-devices", "2"], NotImplementedError),
    (["--data-mesh-cols", "2"], NotImplementedError),
    (["--gp-dtype", "mixed"], ValueError),
    (["--cv-dtype", "mixed"], ValueError),
])
def test_unported_flags_raise(extra, error):
    with pytest.raises(error):
        T.main(BASE + extra)


@pytest.mark.parametrize("method", ["tikhonov", "thresholding"])
def test_regularization_on_the_cg_route_matches_jax_cli(method, capsys):
    """--regularization with the CG posterior (21 train rows > the threshold
    of 8): the low-rank eigenvalue clip, logged as the JAX CLI logs it, at
    the bars of the runs above."""
    flags = [f for f in BASE if f not in ("--device", "cpu", "--quiet")] + [
        "--regularization", method, "--predict-cg-threshold", "8"]
    want = J.main(flags)
    capsys.readouterr()
    got = T.main(flags + ["--device", "cpu"])
    assert "CG posterior applies it via the low-rank eigenvalue clip" in capsys.readouterr().out
    assert set(got) == set(want)
    z, cv = _trajectory(got)
    z_ref, cv_ref = _trajectory(want)
    assert np.abs(z - z_ref).max() <= cs.Z_TOL
    assert np.abs(cv - cv_ref).max() <= cs.NLPD_TOL
    for part in ("test", "train"):
        assert abs(got[f"{part}_metrics"]["nlpd"] - want[f"{part}_metrics"]["nlpd"]) <= cs.NLPD_TOL


def test_plots_without_matplotlib_name_no_plot(monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="--no-plot"):
        T.main([f for f in BASE if f != "--no-plot"])


@pytest.fixture(scope="module")
def fixture():
    with open(cs.CLI_FIXTURE) as f:
        return json.load(f)


def _run_fixture_flags(name):
    """The card's flags on the CPU: the card resolves cond_mode "auto" to
    "host" (the float64 backfill), the CPU to "device"."""
    return cs.CLI_RUNS[name] + ["--device", "cpu", "--cond-mode", "host"]


@pytest.mark.parametrize("name", sorted(cs.CLI_RUNS))
def test_fixture_holds_the_port_cli_at_phase_17s_bars(name, fixture, tmp_path, monkeypatch):
    ref = fixture["runs"][name]
    if name == "A":
        _srtm_tile(str(tmp_path))
        assert cs.file_digest(str(tmp_path / "srtm_data" / "N17E073.hgt")) \
            == ref["tiles_sha256"]["N17E073"]
    summary, stages, split, _ = cs.run_port_cli(
        _run_fixture_flags(name), str(tmp_path / f"run_{name}.log"), cwd=str(tmp_path))
    dev = cs.hold_cli_run(name, summary, split, ref)
    assert {"load", "split", "train", "backfill", "predict_test", "predict_train"} <= set(stages)
    assert stages["backfill"] > 0.0
    if name == "A":
        assert "noise_fit" in stages
        at_z = cs.cli_at_reference_z(split, ref, "cpu")
        assert at_z["sigma_rel"] <= 1e-6   # float64 Grams on both sides
    else:
        assert dev["z"] == 0.0   # config #5's z never moves (ROADMAP Queue 3)


@pytest.mark.parametrize("seam", ["features", "grams"])
def test_run_a_follows_jax_with_jax_float32_grams(seam, fixture, tmp_path, monkeypatch):
    """Run A with the JAX package's float32 features, then also its step
    Grams (the float64 side, the noise fit and the predicts stay the
    port's). With JAX's features alone the run holds the bars past
    CLI_HELD_ITERS; with its Grams as well z is identical at all 5
    iterations and the rest within float64 roundoff. With torch's own
    float32 Matérn Gram the trajectory forks at iteration 2."""
    from test_torch_gate_engines import install_seam

    _srtm_tile(str(tmp_path))
    ref = fixture["runs"]["A"]
    calls = install_seam(seam, monkeypatch)
    with contextlib.redirect_stdout(io.StringIO()):
        summary, _, _, _ = cs.run_port_cli(_run_fixture_flags("A"), str(tmp_path / "run_A.log"),
                                           cwd=str(tmp_path))
    want = ref["summary"]
    z, cv = _trajectory(summary)
    if seam == "features":
        assert calls["features_from_angles"] > 2 * cs.CLI_ITERS
        assert cs.gate_deviations(z, cv, ref)[2] >= cs.CLI_HELD_ITERS + 1
        return
    assert calls["gram_and_shift_grads"] == cs.CLI_ITERS
    np.testing.assert_array_equal(z, np.array(ref["z_trajectory"]))
    np.testing.assert_allclose(cv, ref["cv_nlpd"], rtol=0, atol=1e-9)
    for part in ("test", "train"):
        np.testing.assert_allclose(summary[f"{part}_metrics"]["nlpd"],
                                   want[f"{part}_metrics"]["nlpd"], rtol=0, atol=1e-7)
    np.testing.assert_allclose(summary["noise_fit"]["fitted_noise_std"],
                               want["noise_fit"]["fitted_noise_std"], rtol=1e-7)
