"""pair_contract_launches.train: the streamed gradient's contraction calls
in an iteration (ops/cuda_pair.py, csrc/shift_pair_contract.cu; one a
parameter): the traced run's ``cuda_circuit.launch:pair_contract`` spans
inside its ``driver.iteration`` spans, over its iterations. Nothing where
the program records no such span."""

from bench_torch import spans as S

LAUNCH = "cuda_circuit.launch:pair_contract"


def read(run):
    got = S.training_unit()
    if got is None:
        return None
    u, iters = got
    n = sum(len(u.outer(i, lambda name: name == LAUNCH)) for i in u.named("driver.iteration"))
    return n / iters if n else None
