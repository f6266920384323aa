"""The streamed gradient's contraction kernel (``csrc/shift_pair_contract.cu``,
wrapped by ``dqgp_tpu_torch/ops/cuda_pair.py``) on the CPU: its plain version
against the streamed loop of ``parallel.consensus``; the choice of path, by
what the code observes; a numpy model of the kernel's walk over the tiles
(its work items, the row positions of its staged tiles, the pairs of
bracket columns each thread reads, the symmetric weight off the diagonal,
the mask and the fixed-order sums); and the per-layer metric
``pair_contract_launches.train``. The kernel itself runs only on the card
(``tests/test_torch_cuda.py``).
"""

from __future__ import annotations

import importlib.util
import json
import os
import re

import numpy as np
import pytest
import torch

from dqgp_tpu_torch import manifold as M
from dqgp_tpu_torch import tracing
from dqgp_tpu_torch.models.circuits import build_circuit
from dqgp_tpu_torch.models.gp.posterior import masked_nll_core
from dqgp_tpu_torch.models.kernels import QuantumKernelSpec
from dqgp_tpu_torch.ops import cuda_circuit as K
from dqgp_tpu_torch.ops import cuda_pair as CP
from dqgp_tpu_torch.parallel import consensus as C
from dqgp_tpu_torch.tracing import Span
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H = float(np.pi / 8)
TILE = 64
# the kernel's width limit, read from its source: the CPU cannot build the
# library whose dqgp_shift_pair_contract_max_d() reports it
SOURCE_TEXT = open(os.path.join(ROOT, "dqgp_tpu_torch", "csrc", CP.SOURCE)).read()
KMAX_D = int(re.search(r"constexpr int kMaxD = (\d+);", SOURCE_TEXT).group(1))


def _spec(enc="chebyshev", n=3, outer="matern", params=(), kernel_type="projected",
          regularization=None):
    return QuantumKernelSpec(circuit=build_circuit(enc, n, 2, 1), kernel_type=kernel_type,
                             outer_kernel=outer, outer_kernel_params=params,
                             regularization=regularization)


def _batch(n_agents=4, n_per=9, pad_to=12, seed=0):
    """Ragged shards, padded past the longest: every agent has padded rows."""
    rng = np.random.RandomState(seed)
    splits = []
    for i in range(n_agents):
        ni = n_per - (i % 3)
        X = rng.uniform(-0.9, 0.9, (ni, 2))
        splits.append((X, np.sin(X[:, 0]) + 0.1 * rng.randn(ni)))
    return C.make_agent_batch(splits, "cpu", pad_to=pad_to)


@pytest.mark.parametrize("enc,n", [("chebyshev", 3), ("hubregtsen", 2)])
def test_reference_gathered_over_parameters_is_the_loop(enc, n):
    """g_p of the plain version, parameter by parameter, is the streamed
    loop's gradient bit for bit (the same PyTorch operations)."""
    spec, batch = _spec(enc, n), _batch()
    P = spec.num_parameters
    z32 = torch.tensor(np.random.RandomState(3).uniform(0, np.pi, P), dtype=torch.float32)
    got = C.streamed_nll_and_grad(spec, batch, z32, H, 0.1)
    K0 = C.agent_grams(spec, batch.X, z32[None])[:, 0]
    mask = batch.mask.double()
    _, bracket = masked_nll_core(K0.double(), batch.Y.double(), mask, 0.1)
    eye = torch.eye(P, dtype=torch.float32)
    cols = []
    for p in range(P):
        pair = torch.remainder(torch.stack([z32 + H * eye[p], z32 - H * eye[p]]), M.PERIOD)
        F = C.agent_features(spec, batch.X, pair)
        assert F.shape == (4, 2, 12, 3 * n) and F.dtype == torch.float32
        cols.append(CP.shift_pair_contract_reference(F, bracket, mask, H))
    assert torch.equal(torch.stack(cols, dim=-1), got.grad)
    # the wrapper on the CPU is the plain version, into a column of a gradient
    out = torch.full((4, P), 7.0, dtype=torch.float64)
    CP.shift_pair_contract(F, bracket, mask, H, out=out[:, P - 1])
    assert torch.equal(out[:, P - 1], got.grad[:, P - 1]) and bool((out[:, :-1] == 7.0).all())


CUDA = torch.device("cuda", 0)


@pytest.mark.parametrize("case,want", [
    ({}, True),
    ({"device": torch.device("cpu")}, False),
    ({"feature_dtype": torch.float64}, False),
    ({"gp_dtype": torch.float32}, False),
    ({"spec": dict(kernel_type="fidelity")}, False),
    ({"spec": dict(outer="gaussian")}, False),
    ({"spec": dict(outer="rationalquadratic")}, False),
    ({"spec": dict(regularization="thresholding")}, False),
    ({"spec": dict(params=(("nu", 0.5),))}, True),
    ({"spec": dict(params=(("nu", 2.5),))}, True),
    ({"spec": dict(params=(("nu", float("inf")),))}, True),
    ({"spec": dict(params=(("length_scale", 0.7), ("nu", 2.5)))}, True),
    ({"spec": dict(params=(("nu", 1.0),))}, False),
    ({"width": 1}, True),
    ({"width": 36}, True),
    ({"width": KMAX_D}, True),
    ({"width": KMAX_D + 1}, False),
    ({"width": 0}, False),
])
def test_the_path_follows_what_the_code_observes(monkeypatch, case, want):
    monkeypatch.setattr(CP, "max_d", lambda: KMAX_D)  # the library's answer on the card
    spec = _spec(**case.get("spec", {}))
    assert CP.takes_kernel(spec, case.get("device", CUDA),
                           case.get("feature_dtype", torch.float32), case.get("width", 30),
                           case.get("gp_dtype", torch.float64)) is want


@pytest.mark.parametrize("device,spec_kw", [
    (torch.device("cpu"), {}),
    (CUDA, {"kernel_type": "fidelity"}),
    (CUDA, {"outer": "gaussian"}),
])
def test_a_run_off_the_path_never_loads_the_library(monkeypatch, device, spec_kw):
    """The width limit is asked of the library last, so the CPU and the
    cases that keep the loop on the card never build or load it."""
    def refuse():
        raise AssertionError("the library was asked for its width limit")

    monkeypatch.setattr(CP, "max_d", refuse)
    assert not CP.takes_kernel(_spec(**spec_kw), device, torch.float32, 30, torch.float64)


@pytest.mark.parametrize("spec_kw,dtype", [({}, torch.float64), ({}, torch.float32),
                                           ({"outer": "gaussian"}, torch.float64),
                                           ({"kernel_type": "fidelity"}, torch.float64)])
def test_every_cpu_case_keeps_the_loop(monkeypatch, spec_kw, dtype):
    def refuse(*args, **kwargs):
        raise AssertionError("the CPU took the kernel's path")

    monkeypatch.setattr(CP, "shift_pair_contract", refuse)
    spec = _spec(**spec_kw)
    z32 = torch.rand(spec.num_parameters, dtype=torch.float32)
    res = C.streamed_nll_and_grad(spec, _batch(n_agents=2), z32, H, 0.1, dtype=dtype,
                                  compute_cond=False)
    assert res.grad.shape == (2, spec.num_parameters) and res.grad.dtype == dtype


def test_matern_params_take_outer_grams_defaults():
    assert CP.matern_params(_spec()) == (1.0, 1.5)
    assert CP.matern_params(_spec(params=(("length_scale", 2), ("nu", 0.5)))) == (2.0, 0.5)


def test_launch_counts_carry_the_contraction():
    assert "pair_contract" in K.launch_counts()
    K.reset_launch_counts()
    assert K.launch_counts()["pair_contract"] == 0


# ---------------------------------------------------------------------------
# a numpy model of the kernel's walk
# ---------------------------------------------------------------------------


def model_items(nmax: int) -> int:
    """Work items an agent, one float64 slot each: the lower triangle of its
    Gram's 64-row tiles (the kernel's ``items_of``)."""
    tiles = -(-nmax // TILE)
    return tiles * (tiles + 1) // 2


def decode(t: int):
    """The kernel's (I, J) of triangular index t = I (I + 1) / 2 + J."""
    I = int((np.sqrt(np.float32(8.0) * np.float32(t) + np.float32(1.0)) - np.float32(1.0))
            * np.float32(0.5))
    while I * (I + 1) // 2 > t:
        I -= 1
    while (I + 1) * (I + 2) // 2 <= t:
        I += 1
    return I, t - I * (I + 1) // 2


def row_of(p):
    return 2 * (p & 31) + (p >> 5)


def kernel_model(dK, B, mask):
    """g of every agent as the kernel walks it, from dK (A, N, N) float64,
    exactly symmetric as the kernel's is: each item's tile, each thread's
    4 x 4 entries at positions ty + 16 m (features and mask) and bracket
    rows and column pairs 2 t + 32 (m & 1) + (m >> 1), the weight
    bracket[i, j] + bracket[j, i] off the diagonal, the skipped items."""
    A, N, _ = dK.shape
    items = model_items(N)
    slots = np.zeros(A * items)
    Bp = np.zeros((A, N + TILE, N + TILE))  # loads outside the array read 0
    Bp[:, :N, :N] = B
    mp = np.zeros((A, N + TILE))
    mp[:, :N] = mask
    t_ = np.arange(16)
    ty, tx = t_[:, None], t_[None, :]
    for item in range(A * items):
        a, t = divmod(item, items)
        I, J = decode(t)
        r0i, r0j = I * TILE, J * TILE
        if not (mp[a, r0i:r0i + TILE].any() and mp[a, r0j:r0j + TILE].any()):
            continue
        s = 0.0
        for mi in range(4):
            for mj in range(4):
                ri = r0i + row_of(ty + 16 * mi) + 0 * tx     # the staged rows' positions
                rj = r0j + row_of(tx + 16 * mj) + 0 * ty
                bi = r0i + 2 * ty + 32 * (mi & 1) + (mi >> 1) + 0 * tx  # the bracket's rows
                bj = r0j + 2 * tx + 32 * (mj & 1) + (mj >> 1) + 0 * ty
                assert np.array_equal(ri, bi) and np.array_equal(rj, bj)
                # the direct pair: columns 2 tx + 32 h, + 1 hold mj = h, h + 2
                h, odd = mj & 1, mj >> 1
                w = Bp[a, bi, r0j + 2 * tx + 32 * h + odd]
                if I != J:  # the transposed pair: row j, columns 2 ty + 32 h, + 1
                    h, odd = mi & 1, mi >> 1
                    w = w + Bp[a, bj, r0i + 2 * ty + 32 * h + odd]
                m = mp[a, ri] * mp[a, rj]
                d = dK[a, np.minimum(ri, N - 1), np.minimum(rj, N - 1)]
                s += float(np.sum(np.where(m != 0, w * (d * m), 0.0)))
        slots[item] = s
    return 0.5 * slots.reshape(A, items).sum(axis=1)


@pytest.mark.parametrize("N,rows", [(844, [844, 717, 0]), (150, [150, 1, 64]), (64, [63, 64, 2]),
                                    (7, [5, 7, 7])])
def test_the_walk_covers_every_entry_once(N, rows):
    rng = np.random.RandomState(N)
    A = len(rows)
    mask = np.zeros((A, N))
    for a, n in enumerate(rows):
        mask[a, :n] = 1.0
    d = rng.standard_normal((A, N, N))
    dK = d + d.transpose(0, 2, 1)
    B = rng.standard_normal((A, N, N))
    want = 0.5 * np.sum(B.transpose(0, 2, 1) * dK * mask[:, :, None] * mask[:, None, :],
                        axis=(1, 2))
    got = kernel_model(dK, B, mask)
    np.testing.assert_allclose(got, want, rtol=1e-11, atol=1e-11 * np.abs(B).sum())


def test_item_decode_walks_the_lower_triangle():
    seen = [decode(t) for t in range(model_items(20_000))]
    tiles = -(-20_000 // TILE)
    assert seen == [(I, J) for I in range(tiles) for J in range(I + 1)]


@pytest.mark.parametrize("D", range(1, KMAX_D + 1))
def test_staged_rows_meet_no_bank_twice(D):
    """A float4 read of eight lanes' consecutive positions hits eight distinct
    16-byte bank groups at the kernel's row stride of 4 x odd floats."""
    chunks = -(-D // 4)
    stride = 4 * (chunks | 1)
    assert stride >= 4 * chunks and (stride // 4) % 2 == 1
    for q in range(chunks):
        assert len({(p * stride // 4 + q) % 8 for p in range(8)}) == 8


# ---------------------------------------------------------------------------
# the per-layer metric
# ---------------------------------------------------------------------------


def _metric(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "bench_torch", "metrics", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


MS = 1_000_000  # ns


def _training_spans(launches=True):
    """Two iterations: 3 contraction calls in the first's step, 2 in the
    second's; one outside any iteration, which is not counted."""
    spans = []

    def add(name, start, parent=-1):
        spans.append(Span(name, start * MS, (start + 1) * MS, parent, 5))
        return len(spans) - 1

    add("driver.start", 0)
    for it, calls in enumerate((3, 2)):
        i = add("driver.iteration", 10 + 20 * it)
        d = add("driver.dispatch", 10 + 20 * it, i)
        s = add("consensus.step", 10 + 20 * it, d)
        add("cuda_circuit.launch:K3", 11 + 20 * it, s)
        for k in range(calls if launches else 0):
            add("cuda_circuit.launch:pair_contract", 12 + 20 * it + k, s)
        add("driver.record", 22 + 20 * it, i)
    if launches:
        add("cuda_circuit.launch:pair_contract", 70)
    return spans


def test_pair_contract_launches_reads_the_spans_inside_the_iterations(monkeypatch):
    read = _metric("pair_contract_launches.train")
    box = []
    monkeypatch.setattr(tracing, "spans", lambda: list(box))
    assert read(None) is None
    box[:] = _training_spans(launches=False)  # a program without the kernel
    assert read(None) is None
    box[:] = _training_spans()
    assert read(None) == pytest.approx((3 + 2) / 2)


def test_the_benchmark_declares_the_metric():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    m = {m["name"]: m for m in bench["per_layer"]}["pair_contract_launches.train"]
    assert (m["unit"], m["source"], m["layer"], m["moves"], m["workloads"]) == (
        "count", "program_counter", "Gram and consensus arithmetic", "iter_ms",
        ["config7.train", "config7q12.train"])
    assert bench["per_layer"][-1]["name"] == "pair_contract_launches.train"


def test_the_source_names_no_kernel_of_another_group():
    """The kernels' names fall in the trace's ``elementwise`` group, which
    ``elementwise_ms.train`` reads."""
    from bench_torch.trace import group_of

    for name in ("void (anonymous namespace)::shift_pair_contract_kernel<1>"
                 "((anonymous namespace)::Args)",
                 "(anonymous namespace)::pair_contract_sum_kernel(double const*, int, "
                 "double*, long long)"):
        assert group_of(name) == "elementwise"
    src = SOURCE_TEXT
    assert "__global__ void __launch_bounds__(kThreads, kMinBlocks) shift_pair_contract_kernel" \
        in src
    assert "pair_contract_sum_kernel(" in src and "use_fast_math" not in src
    assert "__expf" not in src and "atomicAdd" not in src


def test_a_cpu_run_reads_no_launch():
    K.reset_launch_counts()
    spec, batch = _spec(), _batch(n_agents=2)
    C.streamed_nll_and_grad(spec, batch, torch.rand(spec.num_parameters), H, 0.1)
    assert K.launch_counts()["pair_contract"] == 0
