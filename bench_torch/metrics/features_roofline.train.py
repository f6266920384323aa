"""features_roofline.train: the float32 features kernels' least time over
their device time, %, whichever of them computed the features: K1
(``warp_pauli_features_kernel``, csrc/pauli_features.cu and its 11-12-qubit
source) or K3 (``warp_features_kernel``, csrc/pauli_features_fused.cu and
its 11-12-qubit source). The work is counted as ``k3_roofline.train``
counts it, the smaller of the gate sequence's and the fused program's
operations, so the same whichever kernel runs: the step's rows at z and at
the 2P shifts, and the CV rows, over the traced iterations. Nothing where
neither kernel was traced."""

import re

FEATURES = re.compile(r"warp_pauli_features_kernel|warp_features_kernel")


def read(run):
    if run.trace is None or not run.traced_work:
        return None
    spent, launches = run.trace.kernel_s(FEATURES)
    if not launches or spent <= 0:
        return None
    rows = run.counts.train_rows_per_iteration(run.cfg)
    least = run.counts.feature_least_s(run.cfg, (rows["step"] + rows["cv"]) * run.traced_work)
    return 100.0 * least / spent
