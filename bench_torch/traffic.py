"""The benchmark's one generator: a cell's inputs from its configuration,
its workload file and ``--seed``.

The seed draws values only. What sets the work is the configuration's:
the rows, the agents and each agent's row count (so the padded shard every
agent is batched to), the CV subsample's size, the posterior's train and
test rows. Inputs are drawn cell by cell of the regional partition's grid:
each agent's rows fall strictly inside its own grid cell, and four anchor
rows sit on the domain's corners of each axis, so the regional split (a
copy of the program's, below) cuts the grid at the same edges for every
seed and gives every agent exactly the configuration's count. The rows are
then shuffled, so the order of the training set (and the CV subsample and
folds drawn from it) moves with the seed too.

The regional partition's grid and the classical targets are copied from
``dqgp_tpu_torch/data/partition.py`` and ``dqgp_tpu_torch/data/synthetic.py``
(main.py:457-522 and 555-682 of the upstream project): the program receives
only the arrays made here.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    """An independent stream for ``seed`` (any non-negative int, also past
    32 bits) and a stream label."""
    return np.random.default_rng(np.random.SeedSequence([int(seed), *map(int, stream)]))


def small_seed(seed: int, *stream: int) -> int:
    """A seed below 2**31 for the program's numpy-legacy seeding (its ADMM
    start, CV subsample and folds add the iteration to it)."""
    state = np.random.SeedSequence([int(seed), *map(int, stream)]).generate_state(1)
    return int(state[0] % (2**31 - 2**20))


# --- targets (copied: dqgp_tpu_torch/data/synthetic.py, bench.py) ---------

def sine_cosine(X: np.ndarray) -> np.ndarray:
    """The north star's target (bench.py:52-77): sin(3 x0) cos(2 x1)."""
    return np.sin(3 * X[:, 0]) * np.cos(2 * X[:, 1])


def goldstein_price_log(X: np.ndarray) -> np.ndarray:
    """The 2-D log-normalized Goldstein-Price of ``generate_data_numpy``."""
    x1, x2 = X[:, 0], X[:, 1]
    fact1 = 1 + (x1 + x2 + 1) ** 2 * (
        19 - 14 * x1 + 3 * x1**2 - 14 * x2 + 6 * x1 * x2 + 3 * x2**2)
    fact2 = 30 + (2 * x1 - 3 * x2) ** 2 * (
        18 - 32 * x1 + 12 * x1**2 + 48 * x2 - 36 * x1 * x2 + 27 * x2**2)
    return (np.log(fact1 * fact2) - 8.693) / 2.427


def sine(X: np.ndarray) -> np.ndarray:
    """The scale-out example's target: sin(3 x0)."""
    return np.sin(3 * X[:, 0])


TARGETS = {"sine_cosine": sine_cosine, "goldstein_price_log": goldstein_price_log,
           "sine": sine}


# --- the regional partition (copied: dqgp_tpu_torch/data/partition.py) ----

def _grid_cell_mask(X: np.ndarray, n_agents: int, agent_id: int):
    N, d = X.shape
    cells_per_dim = round(n_agents ** (1 / d))
    digits = []
    r = agent_id
    for _ in range(d):
        digits.append(r % cells_per_dim)
        r //= cells_per_dim
    digits = digits[::-1]
    mask = np.ones(N, dtype=bool)
    for j, ij in enumerate(digits):
        low, high = X[:, j].min(), X[:, j].max()
        edges = np.linspace(low, high, cells_per_dim + 1)
        mask &= (X[:, j] >= edges[ij]) & (X[:, j] <= edges[ij + 1])
    return mask


def regional_split(X: np.ndarray, Y: np.ndarray,
                   n_agents: int) -> List[Tuple[np.ndarray, np.ndarray]]:
    """The program's ``split_data_numpy(X, Y, n_agents, "regional")`` where
    ``n_agents`` is a perfect d-th power of the inputs' d columns: a regular
    grid between the data's extremes (the program's k-d bisection for other
    counts is not copied; ``grid_inputs`` refuses them)."""
    splits = [np.where(_grid_cell_mask(X, n_agents, a))[0] for a in range(n_agents)]
    return [(X[s], Y[s]) for s in splits]


# --- the generator ----------------------------------------------------------

def grid_inputs(rng: np.random.Generator, counts: Sequence[int], dim: int,
                domain: Tuple[float, float]) -> np.ndarray:
    """Rows uniform inside the cells of the regional grid over ``domain``,
    ``counts[a]`` in agent a's cell (the partition's agent order), with
    anchor rows on both ends of every axis; shuffled."""
    n_agents = len(counts)
    c = round(n_agents ** (1 / dim))
    if c**dim != n_agents:
        raise ValueError(f"{n_agents} agents are no regular grid in {dim} dimensions")
    lo, hi = map(float, domain)
    edges = np.linspace(lo, hi, c + 1)
    width = edges[1] - edges[0]
    margin = 1e-6 * width
    blocks = []
    for a, n in enumerate(counts):
        r, digits = a, []
        for _ in range(dim):
            digits.append(r % c)
            r //= c
        digits = digits[::-1]
        u = rng.uniform(size=(n, dim))
        blk = np.stack([edges[k] + margin + (width - 2 * margin) * u[:, j]
                        for j, k in enumerate(digits)], axis=1)
        # anchors: the grid's edges come from the data's min and max
        for j, k in enumerate(digits):
            if k == 0:
                blk[2 * j % n, j] = lo
            if k == c - 1:
                blk[(2 * j + 1) % n, j] = hi
        blocks.append(blk)
    X = np.concatenate(blocks)
    return X[rng.permutation(len(X))]


def training_data(cfg: dict, seed: int):
    """(agent splits, X_train, Y_train) for a training cell: float64 numpy,
    every agent's count as the configuration's ``partition.agent_rows``."""
    data, part = cfg["data"], cfg["partition"]
    rng = rng_for(seed, 0)
    counts = part["agent_rows"]
    X = grid_inputs(rng, counts, data["dim"], data["domain"])
    Y = TARGETS[data["target"]](X) + data["noise_std"] * rng.standard_normal(len(X))
    splits = regional_split(X, Y, len(counts))
    got = [len(x) for x, _ in splits]
    if got != list(counts):
        raise RuntimeError(f"the regional split gave {got}, not the configuration's counts")
    return splits, X, Y


def posterior_data(cfg: dict, seed: int, unit: int):
    """(X (N + M, D) float32, Y (N,) float32, theta (P,) float32) of one
    posterior: the scale-out example's draws (inputs uniform over the
    encoding's domain, a noisy sine). Theta, which sets how many CG
    iterations a posterior takes, is the configuration's where it gives
    one (the example's own), so that the seed moves the values and not the
    work; else uniform on [0, pi)."""
    post = cfg["posterior"]
    n, m, d = post["train_rows"], post["test_rows"], cfg["data"]["dim"]
    lo, hi = post["domain"]
    rng = rng_for(seed, 1, unit)  # unit 2**20: the warm-up draw
    X = rng.uniform(lo, hi, (n + m, d)).astype(np.float32)
    theta = rng.uniform(0, math.pi, cfg["circuit"]["parameters"]).astype(np.float32)
    if "theta" in post:
        theta = np.asarray(post["theta"], np.float32)
    Y = (TARGETS[post["target"]](X[:n])
         + post["noise_std"] * rng.standard_normal(n)).astype(np.float32)
    return X, Y, theta
