"""features_ms.train: device ms an iteration in the hand kernels (K1-K4,
both precisions), from the trace."""


def read(run):
    if run.trace is None or not run.trace.kernels or not run.traced_work:
        return None
    return 1e3 * run.trace.group_s()["hand"] / run.traced_work
