"""sync_ms.train: the host blocked reading device values in an iteration,
ms: the traced run's ``sync.*`` spans inside its ``driver.iteration`` spans
(the chunk's row fetch, the PSD solve's rescue check, the CV's rescue
check) over its iterations; the backfill's reads stay in
``backfill_ms.train``. Nothing where the program records no spans."""

from bench_torch import spans as S


def read(run):
    got = S.training_unit()
    if got is None:
        return None
    u, iters = got
    return sum(u.ms(j) for j in S.iteration_syncs(u)) / iters
