"""feature_launches.train: the float32 features kernels' launches in an
iteration: the traced run's ``cuda_circuit.launch:K1`` and
``cuda_circuit.launch:K3`` spans inside its ``driver.iteration`` spans,
over its iterations. Nothing where the program records no launch spans."""

from bench_torch import spans as S

LAUNCHES = ("cuda_circuit.launch:K1", "cuda_circuit.launch:K3")


def read(run):
    got = S.training_unit()
    if got is None:
        return None
    u, iters = got
    n = sum(len(u.outer(i, lambda name: name in LAUNCHES)) for i in u.named("driver.iteration"))
    return n / iters if n else None
