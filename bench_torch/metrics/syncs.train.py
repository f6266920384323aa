"""syncs.train: the host's reads of device values in an iteration, the
traced run's ``sync.*`` spans inside its ``driver.iteration`` spans over
its iterations. Nothing where the program records no spans."""

from bench_torch import spans as S


def read(run):
    got = S.training_unit()
    if got is None:
        return None
    u, iters = got
    return len(S.iteration_syncs(u)) / iters
