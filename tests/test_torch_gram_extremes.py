"""The batched eigenvalue kernel (``csrc/gram_extremes.cu``, wrapped by
``dqgp_tpu_torch/ops/cuda_eig.py``) on the CPU: a plain numpy model of its
two stages, held to ``torch.linalg.eigvalsh``; the shape rule that sends a
Gram to the kernel or to eigvalsh; and the wrapper and the backfill
(``driver.host_condition_numbers``) with the launch replaced by the model.
The kernel itself runs only on the card (``tests/test_torch_cuda.py``).

The model follows the kernel's order: LAPACK's dsytd2 (lower) to a
tridiagonal (d, e), then Sturm counts (dlaebz's recurrence, dstebz's pivmin
and widened Gershgorin bounds), each wanted eigenvalue's interval multisected
at 32 shifts a round spread over its doubles' bit patterns, and the
eigenvalues wanted by the count c below zero: 1 and n for max|w|, c and c + 1
for min|w|.

Bar: condition numbers max|w| / max(min|w|, tiny) at rtol 1e-6 where
eigvalsh's lies below 1e8, and in the same bucket (1e8 / 1e12 / 1e15) above
(the benchmark's ``cond`` check, ``bench_torch/entries/train.py``): both
methods are backward stable, so they differ by ~cond * n * eps_f64.
"""

import contextlib
import ctypes
import io
import json
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

import chip_smoke as cs
from dqgp_tpu_torch import driver as TD
from dqgp_tpu_torch import manifold as M
from dqgp_tpu_torch.data import split_data_numpy
from dqgp_tpu_torch.models.kernels.quantum_kernel import grams_at_rows
from dqgp_tpu_torch.ops import cuda_circuit as K
from dqgp_tpu_torch.ops import cuda_eig as E
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

FIXTURE = Path(__file__).resolve().parent / "fixtures" / "torch_port_northstar.json"
BUCKETS = (1e8, 1e12, 1e15)
TINY = np.finfo(np.float64).tiny
EPS = np.finfo(np.float64).eps
SHIFTS = 32


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def tridiagonal(A):
    """dsytd2 (lower) in the kernel's arithmetic: (d, e) of Q^T A Q."""
    A = np.array(A, np.float64)
    n = A.shape[0]
    d, e = np.empty(n), np.empty(max(n - 1, 0))
    for k in range(n - 1):
        x = A[k + 1:, k].copy()
        alpha, s = x[0], float(np.sum(x[1:] * x[1:]))
        tau, beta, scale = 0.0, alpha, 0.0
        if s > 0.0:
            beta = -np.copysign(np.sqrt(alpha * alpha + s), alpha)
            tau = (beta - alpha) / beta
            scale = 1.0 / (alpha - beta)
        d[k], e[k] = A[k, k], beta
        if tau != 0.0:
            v = x * scale
            v[0] = 1.0
            T = A[k + 1:, k + 1:]
            p = tau * (T @ v)
            kk = -0.5 * tau * (p @ v)
            w = p + kk * v
            A[k + 1:, k + 1:] = T - (np.outer(v, w) + np.outer(w, v))
    d[n - 1] = A[n - 1, n - 1]
    return d, e


def sturm_counts(d, e2, sigmas, pivmin):
    """Eigenvalues below each shift (dlaebz's count), for an array of shifts."""
    q = d[0] - sigmas
    q = np.where(np.abs(q) < pivmin, -pivmin, q)
    count = (q <= 0).astype(np.int64)
    for j in range(1, len(d)):
        q = d[j] - e2[j - 1] / q - sigmas
        q = np.where(np.abs(q) < pivmin, -pivmin, q)
        count += q <= 0
    return count


def to_key(x):
    b = np.asarray(x, np.float64).view(np.int64)
    return np.where(b >= 0, b, -(b & np.int64(0x7FFFFFFFFFFFFFFF)))


def from_key(k):
    k = np.asarray(k, np.int64)
    mag = np.abs(k).view(np.float64)
    return np.where(k >= 0, mag, -mag)


def kth_eigenvalues(d, e2, pivmin, ks, los, his):
    """The ks-th smallest eigenvalues (1-based), each in its interval of one
    sign, by 32-shift multisection over the interval's doubles."""
    lo, hi = to_key(los).astype(object), to_key(his).astype(object)  # exact big ints
    lanes = np.arange(1, SHIFTS + 1)
    for _ in range(16):
        live = [i for i in range(len(ks)) if hi[i] - lo[i] > 1]
        if not live:
            break
        keys = np.array([[lo[i] + (hi[i] - lo[i]) // (SHIFTS + 1) * l
                          + (hi[i] - lo[i]) % (SHIFTS + 1) * l // (SHIFTS + 1)
                          for l in lanes] for i in live], np.int64)
        counts = sturm_counts(d, e2, from_key(keys), pivmin)
        for row, i in enumerate(live):
            at = np.flatnonzero(counts[row] >= ks[i])
            first = at[0] if len(at) else SHIFTS
            if first > 0:
                lo[i] = int(keys[row, first - 1])
            if first < SHIFTS:
                hi[i] = int(keys[row, first])
    lo, hi = from_key(lo.astype(np.int64)), from_key(hi.astype(np.int64))
    return 0.5 * (lo + hi)


def model_extremes(A):
    """(max|w|, min|w|) of symmetric A as the kernel computes them."""
    A = np.asarray(A, np.float64)
    if not np.all(np.isfinite(np.tril(A))):
        return np.nan, np.nan
    d, e = tridiagonal(A)
    n, e2 = len(d), e * e
    off = np.abs(np.concatenate([[0.0], e])) + np.abs(np.concatenate([e, [0.0]]))
    lo, hi = float(np.min(d - off)), float(np.max(d + off))
    pivmin = TINY * max(1.0, float(np.max(e2, initial=0.0)))
    widen = 2.1 * max(abs(lo), abs(hi)) * np.finfo(np.float64).eps * n + 4.2 * pivmin
    lo, hi = lo - widen, hi + widen
    c = int(sturm_counts(d, e2, np.array([0.0]), pivmin)[0])
    ks = [k for k in (1, n, c, c + 1) if 1 <= k <= n]
    lam = kth_eigenvalues(d, e2, pivmin, ks,
                          [min(lo, 0.0) if k <= c else 0.0 for k in ks],
                          [0.0 if k <= c else max(hi, 0.0) for k in ks])
    w = dict(zip(ks, np.abs(lam)))
    return max(w[1], w[n]), min(w[k] for k in (c, c + 1) if k in w)


def model_cond(A):
    big, small = model_extremes(A)
    return big / max(small, TINY)


def eigvalsh_cond(A):
    w = E.gram_extremes_reference(torch.as_tensor(np.asarray(A, np.float64))[None])[0]
    return float(w[0] / torch.clamp(w[1], min=TINY))


def _bucket(c):
    return sum(c >= b for b in BUCKETS) if np.isfinite(c) else len(BUCKETS)


def hold(got, want, what=""):
    """The bar: rtol 1e-6 below 1e8, the same bucket above."""
    got, want = np.ravel(got), np.ravel(want)
    for g, w in zip(got, want):
        if w < BUCKETS[0]:
            assert abs(g - w) <= 1e-6 * w, (what, g, w)
        else:
            assert _bucket(g) == _bucket(w), (what, g, w)


def hold_extremes(got, want, n, what=""):
    """max|w| at rtol 1e-10, and min|w| within n * eps * max|w| of eigvalsh's:
    both methods are backward stable on the same float64 matrix. Above a
    condition number of 1e8 this holds the small end, which the bucket does
    not."""
    (gb, gs), (wb, ws) = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert abs(gb - wb) <= 1e-10 * wb, (what, gb, wb)
    assert abs(gs - ws) <= n * EPS * wb, (what, gs, ws, wb)


def eigvalsh_extremes(A):
    return E.gram_extremes_reference(torch.as_tensor(np.asarray(A, np.float64))[None])[0].numpy()


def spectrum_matrix(w, seed=0):
    rng = np.random.RandomState(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((len(w), len(w))))
    A = (Q * np.asarray(w, np.float64)) @ Q.T
    return 0.5 * (A + A.T)


# ---------------------------------------------------------------------------
# the model against eigvalsh
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def northstar():
    """The north star's problem (chip_smoke.make_problem, 4 regional agents of
    238-260 rows) and the z rows of its JAX fixture."""
    ref = json.loads(FIXTURE.read_text())
    X, Y, X_test, Y_test = cs.make_problem()
    assert cs.problem_digest(X, Y, X_test, Y_test) == ref["problem"]["sha256"]
    with contextlib.redirect_stdout(io.StringIO()):
        splits = split_data_numpy(X, Y, cs.N_AGENTS, "regional")
    spec = cs.northstar_spec()
    return spec, splits, np.array(ref["z_trajectory"])


def test_model_tridiagonal_keeps_the_spectrum():
    A = spectrum_matrix(np.linspace(-2.0, 3.0, 17), seed=1)
    d, e = tridiagonal(A)
    T = np.diag(d) + np.diag(e, 1) + np.diag(e, -1)
    np.testing.assert_allclose(np.linalg.eigvalsh(T), np.linalg.eigvalsh(A), atol=1e-13)


@pytest.mark.parametrize("z_index", [0, 2, 4])
def test_model_matches_eigvalsh_on_northstar_grams(northstar, z_index):
    spec, splits, Z = northstar
    zw = M.wrap(torch.as_tensor(Z[z_index:z_index + 1]))
    for X_i, _ in splits:
        G = grams_at_rows(spec, torch.as_tensor(X_i), zw)[0].numpy()
        assert 238 <= G.shape[0] <= 260
        hold(model_cond(G), eigvalsh_cond(G), f"z {z_index}, n {G.shape[0]}")
        hold_extremes(model_extremes(G), eigvalsh_extremes(G), G.shape[0],
                      f"z {z_index}, n {G.shape[0]}")


@pytest.mark.parametrize("cond", [1e2, 1e5, 1e7, 1e10, 1e13, 1e16])
def test_model_matches_eigvalsh_on_synthetic_spectra(cond):
    n = 48
    w = np.geomspace(1.0, 1.0 / cond, n)
    A = spectrum_matrix(w, seed=int(np.log10(cond)))
    want = eigvalsh_cond(A)
    assert _bucket(want) == _bucket(cond)
    hold(model_cond(A), want, f"cond {cond:g}")
    hold_extremes(model_extremes(A), eigvalsh_extremes(A), n, f"cond {cond:g}")


@pytest.mark.parametrize("smallest", [-1e-3, -1e-9, 2e-4])
def test_model_matches_eigvalsh_on_indefinite_matrices(smallest):
    """The smallest |w| a small negative eigenvalue (or a positive one with
    larger negatives around it): the eigenvalues on either side of zero."""
    w = np.array([3.0, 1.5, 0.7, 0.2, smallest, -0.05, -0.4, -1.1, 0.01, 0.9])
    A = spectrum_matrix(w, seed=5)
    big, small = model_extremes(A)
    ref = np.abs(np.linalg.eigvalsh(A))
    np.testing.assert_allclose([big, small], [ref.max(), ref.min()], rtol=1e-6)
    hold(model_cond(A), eigvalsh_cond(A))


@pytest.mark.parametrize("n", [1, 2, 3, 5, 31, 33, 64, 97])
def test_model_matches_eigvalsh_at_small_and_ragged_sizes(n):
    rng = np.random.RandomState(n)
    B = rng.standard_normal((n, n))
    for A in (B + B.T, B @ B.T + 1e-3 * np.eye(n)):
        big, small = model_extremes(A)
        ref = np.abs(np.linalg.eigvalsh(A))
        np.testing.assert_allclose(big, ref.max(), rtol=1e-12)
        hold(model_cond(A), eigvalsh_cond(A), f"n {n}")
        hold_extremes((big, small), eigvalsh_extremes(A), n, f"n {n}")


def test_model_and_eigvalsh_on_a_non_finite_gram():
    """A Gram with a NaN or an inf entry: eigvalsh on the CPU raises
    LinAlgError for these (for others, such as a NaN off the diagonal of an
    identity, it reads NaN): never a finite number. The kernel gives NaN for
    both extremes."""
    A = spectrum_matrix(np.linspace(1.0, 2.0, 6))
    eigvalsh = []
    for where in ((3, 1), (2, 2), (5, 0)):
        for bad in (np.nan, np.inf):
            B = A.copy()
            B[where] = B[where[::-1]] = bad
            try:
                eigvalsh.append(np.isnan(eigvalsh_cond(B)))
            except torch.linalg.LinAlgError:
                eigvalsh.append("raised")
            assert np.all(np.isnan(model_extremes(B)))
    assert set(eigvalsh) <= {True, "raised"}


# ---------------------------------------------------------------------------
# the shape rule
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("C", E.CLUSTER_SIZES)
def test_cluster_limit_is_the_last_size_that_fits(C):
    lim = E.cluster_limit(C)
    assert E.smem_bytes(lim, C) <= E.SMEM_BUDGET < E.smem_bytes(lim + 1, C)
    assert E.cluster_size(lim) == C
    if C < E.CLUSTER_SIZES[-1]:
        assert E.cluster_size(lim + 1) == E.CLUSTER_SIZES[E.CLUSTER_SIZES.index(C) + 1]


def test_shape_rule_routes_each_size():
    limits = {C: E.cluster_limit(C) for C in E.CLUSTER_SIZES}
    assert list(limits.values()) == sorted(limits.values())
    assert E.MAX_N == limits[8]
    for n in range(1, E.MAX_N + 1):
        C = E.cluster_size(n)
        assert E.smem_bytes(n, C) <= E.SMEM_BUDGET
        assert all(E.smem_bytes(n, c) > E.SMEM_BUDGET for c in E.CLUSTER_SIZES if c < C)
        assert E.takes_kernel(n, "cuda") and not E.takes_kernel(n, "cpu")
    assert E.cluster_size(E.MAX_N + 1) is None and not E.takes_kernel(E.MAX_N + 1, "cuda")
    # config #5's 225 rows: one block; the north star's 238-260: clusters of
    # two; config #7's 717-844: eigvalsh
    assert E.cluster_size(225) == 1
    assert {E.cluster_size(n) for n in range(238, 261)} == {2}
    assert not any(E.takes_kernel(n, "cuda") for n in range(717, 845))


# ---------------------------------------------------------------------------
# the wrapper and the backfill, the launch replaced by the model
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def model_launch():
    """The card's path on the CPU: the wrapper routes as on the card, and the
    launch reads each Gram at its table address and runs the model."""
    launches = []

    def launch(table, out, nmax, C, device):
        launches.append((table.clone(), nmax, C))
        for g, (addr, n) in enumerate(table.tolist()):
            G = np.ctypeslib.as_array((ctypes.c_double * (n * n)).from_address(addr))
            out[g] = torch.as_tensor(model_extremes(G.reshape(n, n)))

    K.reset_launch_counts()
    with mock.patch.object(E, "_on_card", lambda device: True), \
            mock.patch.object(E, "_launch", launch):
        try:
            yield launches
        finally:
            K.reset_launch_counts()


def test_wrapper_builds_the_table_and_routes_by_size():
    rng = np.random.RandomState(3)
    sizes = [(3, 40), (2, E.MAX_N + 2), (0, 7), (4, 9), (1, 250)]
    grams = []
    for T, n in sizes:
        B = rng.standard_normal((max(T, 1), n, n))
        grams.append(torch.as_tensor(B + B.transpose(0, 2, 1))[:T])
    with model_launch() as launches:
        got = E.gram_extremes(grams)
        counts = K.launch_counts()
    assert got.shape == (10, 2) and got.dtype == torch.float64
    (table, nmax, C), = launches
    assert (nmax, C) == (250, E.cluster_size(250))
    assert table[:, 1].tolist() == [40] * 3 + [9] * 4 + [250]
    assert table[:, 0].tolist() == (
        [grams[0].data_ptr() + t * 40 * 40 * 8 for t in range(3)]
        + [grams[3].data_ptr() + t * 9 * 9 * 8 for t in range(4)] + [grams[4].data_ptr()])
    assert (counts["eig"], counts["eig_grams"], counts["eig_eigvalsh_grams"]) == (1, 8, 2)
    want = torch.cat([E.gram_extremes_reference(g) for g in grams])
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=1e-10)
    hold((got[:, 0] / got[:, 1]).numpy(), (want[:, 0] / want[:, 1]).numpy())


def test_wrapper_reduces_each_eigvalsh_batch_before_drawing_the_next():
    """The backfill hands the wrapper a generator that builds each agent's
    Grams: a batch above the kernel's limit is reduced by eigvalsh before the
    next batch is built, so at most one such batch is held at once; the
    batches the kernel takes go in one launch after the last is drawn."""
    events, real = [], E.gram_extremes_reference
    rng = np.random.RandomState(4)

    def reference(g):
        events.append(("eigvalsh", g.shape[1]))
        return real(g)

    def batches():
        for n in (9, E.MAX_N + 1, 7, E.MAX_N + 2):
            events.append(("build", n))
            B = rng.standard_normal((2, n, n))
            yield torch.as_tensor(B + B.transpose(0, 2, 1))

    with model_launch() as launches, mock.patch.object(E, "gram_extremes_reference", reference):
        got = E.gram_extremes(batches())
        counts = K.launch_counts()
    big = (E.MAX_N + 1, E.MAX_N + 2)
    assert events == [("build", 9), ("build", big[0]), ("eigvalsh", big[0]), ("build", 7),
                      ("build", big[1]), ("eigvalsh", big[1])]
    (table, nmax, _), = launches
    assert nmax == 9 and table[:, 1].tolist() == [9, 9, 7, 7]
    assert got.shape == (8, 2)
    assert (counts["eig"], counts["eig_grams"], counts["eig_eigvalsh_grams"]) == (1, 4, 4)


def test_non_finite_gram_reads_nan_and_the_backfill_raises(northstar):
    """The kernel reads NaN for a Gram with a non-finite entry and the
    wrapper passes it on; the backfill then raises LinAlgError, as eigvalsh
    does on such a Gram (on the CPU here, on the card in
    tests/test_torch_cuda.py)."""
    G = torch.as_tensor(spectrum_matrix(np.linspace(1.0, 2.0, 8)))[None].repeat(3, 1, 1)
    G[1, 5, 2] = G[1, 2, 5] = float("nan")
    with model_launch():
        got = E.gram_extremes([G])
    assert torch.isnan(got[1]).all() and not torch.isnan(got[[0, 2]]).any()
    spec, splits, Z = northstar
    rows = Z[:2].copy()
    rows[1, 3] = np.nan
    with pytest.raises(torch.linalg.LinAlgError):
        TD.host_condition_numbers(spec, splits[:2], rows, device="cpu")
    with model_launch():
        with pytest.raises(torch.linalg.LinAlgError):
            TD.host_condition_numbers(spec, splits[:2], rows, device="cpu")


def test_wrapper_checks_its_input():
    g = torch.zeros((2, 4, 4), dtype=torch.float64)
    with pytest.raises(TypeError):
        E.gram_extremes([g.float()])
    with pytest.raises(ValueError):
        E.gram_extremes([g[:, :, :3]])
    with pytest.raises(ValueError):
        E.gram_extremes([g, torch.zeros((1, 2, 2), dtype=torch.float64, device="meta")])
    with pytest.raises(ValueError):
        E.gram_extremes([g.transpose(1, 2)])


def test_cpu_backfill_counts_nothing_and_launches_nothing(northstar):
    spec, splits, Z = northstar
    K.reset_launch_counts()
    with mock.patch.object(E, "_launch", side_effect=AssertionError("launched")):
        got = TD.host_condition_numbers(spec, splits[:2], Z[:2], device="cpu")
    assert got.shape == (2, 2) and np.all(np.isfinite(got))
    assert K.launch_counts() == dict.fromkeys(K.launch_counts(), 0)


def test_backfill_through_the_kernel_path_matches_eigvalsh(northstar):
    """The north star's backfill with the card's routing: one launch a chunk
    of 16 z rows for all four agents, their Grams in agent order, and the
    condition numbers of the present eigvalsh path."""
    spec, splits, Z = northstar
    rows = np.concatenate([Z, Z[:1] + 0.01])  # 6 rows: chunk=4 gives 2 chunks
    want = TD.host_condition_numbers(spec, splits, rows, chunk=4, device="cpu")
    with model_launch() as launches:
        got = TD.host_condition_numbers(spec, splits, rows, chunk=4, device="cpu")
        counts = K.launch_counts()
    assert [len(t) for t, _, _ in launches] == [4 * 4, 4 * 2]
    n = [len(x) for x, _ in splits]
    assert launches[1][0][:, 1].tolist() == [m for m in n for _ in range(2)]
    assert all(C == 2 for _, _, C in launches)
    assert (counts["eig"], counts["eig_grams"], counts["eig_eigvalsh_grams"]) == (2, 24, 0)
    hold(got, want)


def test_backfill_sends_agents_above_the_limit_to_eigvalsh(northstar, monkeypatch):
    spec, splits, Z = northstar
    n = sorted(len(x) for x, _ in splits)
    monkeypatch.setattr(E, "MAX_N", n[1])  # two agents above the limit
    want = TD.host_condition_numbers(spec, splits, Z[:3], device="cpu")
    with model_launch() as launches:
        got = TD.host_condition_numbers(spec, splits, Z[:3], device="cpu")
        counts = K.launch_counts()
    (table, nmax, _), = launches
    assert nmax == n[1] and sorted(set(table[:, 1].tolist())) == n[:2]
    assert (counts["eig"], counts["eig_grams"], counts["eig_eigvalsh_grams"]) == (1, 6, 6)
    hold(got, want)
