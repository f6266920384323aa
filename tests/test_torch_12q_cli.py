"""Phase 19c's run E on the CPU: config #7's CLI flags at 12 qubits, with
the CLI's condition numbers and the noise fit, on the CG route
(``chip_smoke.RUN_E_CPU_FLAGS``: 40 train rows over 2 agents, 1 iteration),
through the port's CLI against the JAX CLI's run recorded in
tests/fixtures/torch_port_12q.json (scripts/record_torch_port_12q.py), at
run C's bars: the dataset after the split X exact, Y 1e-12; z 5e-3 and
CV-NLPD 0.05 over SCALE_OUT_HELD_ITERS; the condition numbers' buckets; at
JAX's own z the fitted sigma within 1e-3 and the test and train NLPD within
``chip_smoke.scale_out_nlpd_bar``, the CG route within PERF.md §2's CG bars
of the dense posterior.
"""

import json

import chip_smoke as cs
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def test_run_e_at_cpu_size_holds_the_fixture(tmp_path):
    with open(cs.Q12_FIXTURE) as f:
        ref = json.load(f)["run_e_cpu"]
    flags = cs.RUN_E_CPU_FLAGS + ["--cond-mode", "host"]  # as the card resolves "auto"
    assert ref["flags"] == flags
    summary, stages, split, _ = cs.run_port_cli(flags + ["--device", "cpu"],
                                                str(tmp_path / "run_E.log"),
                                                cwd=str(tmp_path))
    assert {"train", "backfill", "noise_fit", "predict_test", "predict_train"} <= set(stages)
    dev = cs.hold_scale_out_run("E", summary, split, ref)
    assert dev["Y"] <= cs.SCALE_OUT_Y_TOL
    assert cs._cond_buckets(summary) == cs._cond_buckets(ref["summary"])
    at_z = cs.run_e_at_reference_z(flags, split, ref, "cpu")
    assert at_z["sigma_rel"] <= cs.SIGMA_RTOL
