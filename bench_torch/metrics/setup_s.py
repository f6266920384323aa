"""setup_s: seconds from the process's start to the window: imports, the
card's first touch, the inputs, and one whole unit of warm-up (the first
run in a checkout also builds the CUDA kernels)."""


def read(run):
    return run.setup_s
