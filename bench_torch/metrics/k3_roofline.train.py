"""k3_roofline.train: K3's (csrc/pauli_features_fused.cu) least time over
its device time, %, counted as K1's (the features' operations are the
smaller of the gate sequence's and the fused program's, whichever kernel
runs them): the step's rows at z and at the 2P shifts, and the CV rows.
Nothing where no K3 launch was traced."""

import re

K3 = re.compile(r"warp_features_kernel")


def read(run):
    if run.trace is None or not run.traced_work:
        return None
    spent, launches = run.trace.kernel_s(K3)
    if not launches or spent <= 0:
        return None
    rows = run.counts.train_rows_per_iteration(run.cfg)
    least = run.counts.feature_least_s(run.cfg, (rows["step"] + rows["cv"]) * run.traced_work)
    return 100.0 * least / spent
