"""Phase 18b's checks of the port's CLI on the CPU: ``--regularization``
on the CG route (the low-rank eigenvalue clip) against the JAX CLI's runs
recorded in tests/fixtures/torch_port_scale_out.json
(scripts/record_torch_port_scale_out.py), at the CPU size the fixture also
records (``chip_smoke.SCALE_OUT_CPU_RUNS``: config #7's CLI flags at the
north star's circuit, 4 agents and 270 train rows). Bars: the dataset after
the split X exact, Y 1e-12; z 5e-3 and CV-NLPD 0.05 over
SCALE_OUT_HELD_ITERS; at JAX's own z the test and train NLPD within
max(0.05, twice JAX's own spread over float64 features and over the dense
posterior) (``chip_smoke.scale_out_nlpd_bar``), the CG route within PERF.md
§2's CG bars of the dense regularized posterior, and the clip's lambda_min
within 1e-6 of JAX's.
"""

import json

import pytest

import chip_smoke as cs
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def scale_out_fixture():
    with open(cs.SCALE_OUT_FIXTURE) as f:
        return json.load(f)


@pytest.mark.parametrize("name", sorted(cs.SCALE_OUT_CPU_RUNS))
def test_scale_out_fixture_holds_the_port_cli(name, scale_out_fixture, tmp_path):
    """Run C (thresholding) or D (tikhonov) through the port's CLI on the
    CPU, held as phase 18b holds runs C and D on the card."""
    ref = scale_out_fixture["cpu_runs"][name]
    flags = cs.SCALE_OUT_CPU_RUNS[name]
    assert ref["flags"] == flags
    summary, stages, split, _ = cs.run_port_cli(flags + ["--device", "cpu"],
                                                str(tmp_path / f"run_{name}.log"),
                                                cwd=str(tmp_path))
    with open(tmp_path / f"run_{name}.log") as f:
        assert "low-rank eigenvalue clip" in f.read()
    assert {"train", "predict_test", "predict_train"} <= set(stages)
    dev = cs.hold_scale_out_run(name, summary, split, ref)
    assert dev["Y"] <= cs.SCALE_OUT_Y_TOL
    at_z = cs.scale_out_at_reference_z(flags, split, ref, "cpu")
    # both float64 LOBPCGs on a positive definite Gram: w = 0 on both sides,
    # lambda_min an unconverged Ritz value within 1e-6 of the Gram's scale
    assert at_z["nonzero_w"] == ref["clip"][0]["nonzero_w"] == 0
    assert abs(at_z["lambda_min"] - at_z["jax_lambda_min"]) <= 1e-6
