"""iter_ms: the window's wall time over the ADMM iterations it completed,
in ms. Each training run's start and its host backfill are inside."""


def read(run):
    return run.window_s * 1e3 / run.work if run.work else None
