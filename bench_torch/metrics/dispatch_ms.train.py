"""dispatch_ms.train: the host's dispatch of an iteration, ms: the traced
run's ``driver.dispatch`` spans (the fold upload, the step and the CV pass
as the host enqueues them) less the host reads and the CUDA-graph capture
inside them, over the run's iterations. Nothing where the program records
no spans.

Where the card is busy throughout (``config7.train``), most of it is the
host blocked in ``cudaLaunchKernel`` on a full launch queue: there it reads
back-pressure, and moves with the device's time rather than the host's own
work; on the north star a launch is the host's own few microseconds."""

from bench_torch import spans as S


def read(run):
    got = S.training_unit()
    if got is None:
        return None
    u, iters = got

    def hidden(name):
        return S.is_sync(name) or name == "driver.capture"

    return sum(u.ms(i) - sum(u.ms(j) for j in u.outer(i, hidden))
               for i in u.named("driver.dispatch")) / iters
