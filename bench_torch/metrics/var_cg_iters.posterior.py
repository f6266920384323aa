"""var_cg_iters.posterior: the variance solve's CG iterations in the traced
posterior, all its test chunks together: the ``blocked.cg_iteration`` spans
inside its ``blocked.var_solve`` spans. Nothing where the program records
no spans."""

from bench_torch import spans as S


def read(run):
    u = S.traced_unit()
    solves = u.named("blocked.var_solve") if u is not None else []
    if not solves:
        return None
    return sum(len(u.outer(i, lambda name: name == "blocked.cg_iteration")) for i in solves)
