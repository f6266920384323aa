"""elementwise_ms.train: device ms an iteration in elementwise kernels,
copies and reductions (the Gram's arithmetic, the consensus update), from
the trace."""


def read(run):
    if run.trace is None or not run.trace.kernels or not run.traced_work:
        return None
    return 1e3 * run.trace.group_s()["elementwise"] / run.traced_work
