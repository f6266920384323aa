"""solve_ms.train: device ms an iteration in Cholesky factorizations and
triangular solves, from the trace."""


def read(run):
    if run.trace is None or not run.trace.kernels or not run.traced_work:
        return None
    g = run.trace.group_s()
    return 1e3 * (g["cholesky"] + g["trsm"]) / run.traced_work
