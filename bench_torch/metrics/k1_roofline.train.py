"""k1_roofline.train: K1's (float32, csrc/pauli_features.cu) least time
over its device time, %. The least time is the larger of its bytes over
the memory rate and its operations over the FP32 rate, for the rows the
window's iterations sent it: every agent's padded shard at the 2P + 1
parameter vectors, and the CV rows. Nothing where no K1 launch was
traced."""

import re

K1 = re.compile(r"warp_pauli_features_kernel")


def read(run):
    if run.trace is None or not run.traced_work:
        return None
    spent, launches = run.trace.kernel_s(K1)
    if not launches or spent <= 0:
        return None
    rows = run.counts.train_rows_per_iteration(run.cfg)
    least = run.counts.feature_least_s(run.cfg, (rows["step"] + rows["cv"]) * run.traced_work)
    return 100.0 * least / spent
