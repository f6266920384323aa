"""cg_host_ms.posterior: the host's turn in a CG iteration, ms: the traced
posterior's ``blocked.cg_iteration`` spans (alpha and variance solves) less
the residual reads that end them (``sync.cg_residual``), over all its CG
iterations. Nothing where the program records no spans."""

from bench_torch import spans as S


def read(run):
    u = S.traced_unit()
    its = u.named("blocked.cg_iteration") if u is not None else []
    if not its:
        return None

    def residual(name):
        return name == "sync.cg_residual"

    return sum(u.ms(i) - sum(u.ms(j) for j in u.outer(i, residual)) for i in its) / len(its)
