"""The yardstick's arithmetic: the card's peaks, and the operations and
bytes of each piece of work, from the configuration's shapes alone.

Nothing here reads the program. The per-sample operation counts of the
hand kernels are copied from ``chip_smoke.py`` (``gate_ops``,
``fused_program_ops``, ``feature_ops``), with one correction: the features
read the same work whichever kernel computes them, the smaller of the gate
sequence's count and the fused program's. The configuration's file holds
that number (``counts.feature_ops_per_sample``); ``gate_ops`` and
``feature_ops`` below recompute its parts from the configuration's gate
list, and a CPU test holds the file to them.
"""

from __future__ import annotations

from typing import Dict

# NVIDIA H100 SXM, published dense peaks at its full 700 W (the data sheet).
PEAKS = {
    "fp32": 67e12,          # FP32 outside the tensor cores (TF32 is off)
    "fp64_tensor": 67e12,   # FP64 tensor cores: cuBLAS/cuSOLVER float64 work
    "fp64": 34e12,          # FP64 outside the tensor cores: the float64 hand kernels
    "hbm_bytes": 3.35e12,   # HBM3 bytes a second
}

ROT = {"rx", "ry", "rz"}
CROT = {"crx", "cry", "crz"}


def gate_ops(circuit: dict) -> int:
    """Operations a sample of the unfused gate sequence (K1, K2): a
    multiply or an add one, a fused multiply-add two, a sine or cosine one;
    swaps and sign flips none (chip_smoke.py's ``gate_ops``)."""
    dim, ops = 1 << int(circuit["qubits"]), 0
    for g in circuit["gates"]:
        k = g["kind"]
        if k == "rzz":
            ops += 3 + 6 * dim
        elif k == "h":
            ops += 8 * (dim // 2)
        elif k in ROT or k in CROT:
            ops += 3 + 12 * (dim // 4 if k in CROT else dim // 2)
    return ops


def feature_ops(n: int) -> int:
    """<X_q>, <Y_q>, <Z_q> of every qubit: 16 operations an amplitude pair."""
    return n * (16 * (1 << (n - 1)) + 2)


def feature_least_s(cfg: dict, rows: float, real_bytes: int = 4) -> float:
    """The least time of the features of ``rows`` samples: angles in and
    features out over the memory rate, or the operations over the rate of
    their type, whichever is larger."""
    c = cfg["counts"]
    n, G = int(cfg["circuit"]["qubits"]), len(cfg["circuit"]["gates"])
    ops = rows * c["feature_ops_per_sample"]
    nbytes = rows * real_bytes * (G + 3 * n)
    rate = PEAKS["fp32"] if real_bytes == 4 else PEAKS["fp64"]
    return max(nbytes / PEAKS["hbm_bytes"], ops / rate)


def _agents(cfg: dict):
    rows = cfg["partition"]["agent_rows"]
    return len(rows), max(rows), rows


def train_rows_per_iteration(cfg: dict) -> Dict[str, int]:
    """Feature rows an iteration sends through the float32 kernel: the
    step's (every agent's padded shard at z and at the 2P shifts, central
    and streamed alike) and the CV pass's."""
    A, nmax, _ = _agents(cfg)
    P = int(cfg["circuit"]["parameters"])
    tr = cfg["train"]
    n_cv = tr["cv_max_samples"] or sum(cfg["partition"]["agent_rows"])
    return {"step": A * nmax * (2 * P + 1), "cv": int(n_cv)}


def _cv_sizes(n: int, k: int):
    sizes = [n // k + (1 if i < n % k else 0) for i in range(k)]
    return [(n - v, v) for v in sizes]


def train_iteration_least_s(cfg: dict) -> float:
    """The least time of one training iteration's counted work at the
    card's peaks, with the host backfill's share where the configuration
    computes condition numbers: the hand kernels' features, the Grams'
    products (float32, 2 D a Gram entry), and the float64 factorizations,
    inverses, contractions and eigenvalues (n^3/3 a Cholesky, n^3 a
    triangular solve of n right-hand sides, 4 n^3/3 an eigvalsh)."""
    A, nmax, rows = _agents(cfg)
    P = int(cfg["circuit"]["parameters"])
    D = 3 * int(cfg["circuit"]["qubits"])
    r = train_rows_per_iteration(cfg)
    t = feature_least_s(cfg, r["step"] + r["cv"])
    fp32 = 2 * D * A * (2 * P + 1) * nmax**2
    fp64 = A * (nmax**3 / 3 + 2 * nmax**3 + 2 * P * nmax**2)
    # the CV's fold Grams are float64: its features are upcast first
    for tr, va in _cv_sizes(r["cv"], int(cfg["train"]["cv_folds"])):
        fp64 += 2 * D * (tr * tr + va * tr) + tr**3 / 3 + tr * tr * va + 2 * va * tr
    t += fp32 / PEAKS["fp32"] + fp64 / PEAKS["fp64_tensor"]
    if cfg["train"]["compute_cond"]:
        # per iteration: every agent's float64 features, Gram and eigvalsh
        t += feature_least_s(cfg, sum(rows), real_bytes=8)
        t += sum(2 * D * n * n + 4 * n**3 / 3 for n in rows) / PEAKS["fp64_tensor"]
    return t


def gram_tile(cfg: dict):
    """(rows, inner, width) of one Gram tile of the posterior's matvec: the
    training rows padded to whole tiles, against one tile's width of them,
    over the 3n features. The width is the configuration's block, clamped
    as ``parallel.blocked.gram_matvec`` clamps it (to N rounded up to a
    multiple of 256, and at least 256)."""
    n = int(cfg["posterior"]["train_rows"])
    w = min(int(cfg["posterior"]["block"]), max(256, -(-n // 256) * 256))
    return -(-n // w) * w, 3 * int(cfg["circuit"]["qubits"]), w


def posterior_least_s(cfg: dict, matvecs: int, alpha_iters: int) -> float:
    """The least time of one posterior's counted work at the FP32 peak,
    from the configuration's sizes and the number of the CG's matvecs.

    Counted: the features of the N training and M test rows; the
    preconditioner (r Gram rows at 2 D an entry, their rank-r updates,
    L L^T and its Cholesky); the mean's N M Gram entries and product; and
    every CG iteration: the N^2 Gram entries of the matvec at 2 D each, the
    product with its right-hand sides (one in the alpha solve's
    ``alpha_iters``, the M test columns in the variance solve's other
    ``matvecs - alpha_iters``), and the Woodbury preconditioner's two
    r x N products on them. The CG's vector updates are not counted."""
    p = cfg["posterior"]
    N, M, r = int(p["train_rows"]), int(p["test_rows"]), int(p["precond_rank"])
    if M > 512:
        raise ValueError("the variance solve is counted as one block of at most 512 columns")
    D = 3 * int(cfg["circuit"]["qubits"])
    var_iters = matvecs - alpha_iters

    def matvec(R):
        return 2 * D * N * N + 2 * N * N * R + 4 * r * N * R + 2 * r * r * R

    flops = r * 2 * D * N + 2 * r * r * N + 2 * r * r * N + r**3 / 3
    flops += 2 * D * N * M + 2 * N * M + 2 * N * M
    flops += (4 * r * N + 2 * r * r) * (1 + M)  # each solve's first preconditioning
    flops += alpha_iters * matvec(1) + var_iters * matvec(M)
    return feature_least_s(cfg, N + M) + flops / PEAKS["fp32"]
