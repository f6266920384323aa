"""record_ms.train: the host's bookkeeping of an iteration, ms: the traced
run's ``driver.record`` spans (``record_iteration``: the history rows, CV
model selection, the stopping rules) over its iterations. Nothing where the
program records no spans."""

from bench_torch import spans as S


def read(run):
    got = S.training_unit()
    if got is None:
        return None
    u, iters = got
    return sum(u.ms(i) for i in u.named("driver.record")) / iters
