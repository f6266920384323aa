"""posterior_s: the window's wall time over the posteriors it completed,
in s (features, CG set-up and alpha solve, mean and variance)."""


def read(run):
    return run.window_s / run.work if run.work else None
