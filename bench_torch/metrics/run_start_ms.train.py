"""run_start_ms.train: the one-time cost a training run pays, ms: the
traced run's ``driver.start`` (the agent batch, the step's construction,
the uploads, the CV subsample and the fold buffers) plus its
``driver.capture`` (a chained run's eager warm-up and CUDA-graph capture).
Nothing where the program records no spans."""

from bench_torch import spans as S


def read(run):
    got = S.training_unit()
    if got is None:
        return None
    u, _ = got
    return sum(u.ms(i) for name in ("driver.start", "driver.capture") for i in u.named(name))
