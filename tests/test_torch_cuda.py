"""Tests that need the card: the CUDA circuit kernels — Pauli features (K1,
float32 and float64, 1-12 qubits), states (K2, float32 and float64),
fused-program Pauli features (K3, 1-12 qubits), fused-program states (K4)
and the adjoint (the backward of K1 and K2) — against their plain PyTorch
versions, on CUDA tensors; the batched eigenvalue kernel of the
condition-number backfill against torch.linalg.eigvalsh; the streamed
gradient's contraction kernel against its plain version and the loop; and
the manifold optimizer on points on the card. They skip where there is no card.

On a GPU host, where JAX need not be installed (the port does not use it),
bypass conftest.py, which imports JAX:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import pytest
import torch

from dqgp_tpu_torch import config
from dqgp_tpu_torch.models.circuits import ENCODING_TYPES, build_circuit
from dqgp_tpu_torch.models.kernels import QuantumKernelSpec
from dqgp_tpu_torch.models.kernels import quantum_kernel as TQ
from dqgp_tpu_torch.ops import cuda_circuit as K1
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("enc", ENCODING_TYPES)
def test_kernel_matches_plain_on_card(cuda, enc):
    gen = torch.Generator(device=cuda).manual_seed(1)
    for n in range(1, K1.MAX_QUBITS["K1"] + 1):  # every instantiation of the float32 kernel
        c = build_circuit(enc, n, 2, 2)
        for B in (1, 257):
            a = (torch.rand((B, c.num_gates), generator=gen, device=cuda) * 4 - 1) * 3.14159
            before = K1.pauli_features_from_angles.launches
            got = K1.pauli_features_from_angles(c, a)
            torch.cuda.synchronize()
            assert K1.pauli_features_from_angles.launches == before + 1
            want = K1.pauli_features_reference(c, a)
            # float32 features (tests/test_pallas_circuit.py's bar)
            assert float((got - want).abs().max()) <= 5e-6


def _angles(gen, c, B, dtype):
    return (torch.rand((B, c.num_gates), generator=gen, device=gen.device,
                       dtype=dtype) * 4 - 1) * 3.14159


@pytest.mark.parametrize("enc", ENCODING_TYPES)
def test_states_kernels_match_plain_on_card(cuda, enc):
    """K2 float32 at 2e-6 (tests/test_pallas_circuit.py), K2 and K1 float64
    at 1e-12 (tests/test_native.py), K4 at 3e-6 (tests/test_fusion.py)
    against the plain fused engine and the plain unfused states, for every
    qubit count the kernels are built for (both sides of the register/lane
    split), one launch a call."""
    gen = torch.Generator(device=cuda).manual_seed(2)
    for n in range(1, K1.ONE_WARP_QUBITS + 1):
        c = build_circuit(enc, n, 2, 2)
        for B in (1, 257):
            a32, a64 = _angles(gen, c, B, torch.float32), _angles(gen, c, B, torch.float64)
            before = K1.launch_counts()
            got = {
                "K2": K1.states_from_angles(c, a32),
                "K2_f64": K1.states_from_angles(c, a64),
                "K1_f64": K1.pauli_features_from_angles(c, a64),
                "K4": K1.states_from_angles_fused(c, a32),
            }
            torch.cuda.synchronize()
            after = K1.launch_counts()
            assert all(after[k] == before[k] + 1 for k in got)
            assert got["K2"].shape == got["K4"].shape == (B, 1 << n)
            assert got["K2"].dtype == got["K4"].dtype == torch.complex64
            plain = K1.states_reference(c, a32)
            assert float((got["K2"] - plain).abs().max()) <= 2e-6
            assert float((got["K4"] - plain).abs().max()) <= 3e-6
            assert float((got["K4"] - K1.states_fused_reference(c, a32)).abs().max()) <= 3e-6
            assert float((got["K2_f64"] - K1.states_reference(c, a64)).abs().max()) <= 1e-12
            assert float((got["K1_f64"] - K1.pauli_features_reference(c, a64))
                         .abs().max()) <= 1e-12


@pytest.mark.parametrize("enc", ENCODING_TYPES)
@pytest.mark.parametrize("output", K1.VJP_OUTPUTS)
def test_adjoint_kernel_matches_plain_on_card(cuda, enc, output):
    """The adjoint kernel against torch.autograd through K1's / K2's plain
    version, within 5e-5 of max(1, max |g|) (chip_smoke.py's VJP_TOL), for
    every qubit count, one launch a call."""
    gen = torch.Generator(device=cuda).manual_seed(6)
    for n in range(1, K1.ONE_WARP_QUBITS + 1):
        c = build_circuit(enc, n, 2, 2)
        for B in (1, 257):
            a = _angles(gen, c, B, torch.float32)
            if output == "features":
                cot = torch.rand((B, 3 * n), generator=gen, device=cuda) * 2 - 1
            else:
                cot = torch.randn((B, c.dim), generator=gen, device=cuda, dtype=torch.complex64)
            key = "K1_vjp" if output == "features" else "K2_vjp"
            before = K1.launch_counts()[key]
            got = K1.circuit_vjp(c, a, cot, output)
            torch.cuda.synchronize()
            assert K1.launch_counts()[key] == before + 1
            want = K1.circuit_vjp_reference(c, a, cot, output)
            assert float((got - want).abs().max()) <= 5e-5 * max(1.0, float(want.abs().max()))


@pytest.mark.parametrize("output", K1.VJP_OUTPUTS)
def test_adjoint_kernel_at_config7_step_shape(cuda, output):
    """The adjoint at config #7's autodiff step shape (chebyshev 10 qubits /
    2 layers, B = 64 x 844 = 54,016: a warp a sample, every lane bit),
    one launch, held to the plain version on the first and the last 2,048
    rows (the plain autograd's saved states of all rows do not fit)."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    c = build_circuit("chebyshev", 10, 2, 2)
    B, rows = 64 * 844, 2048
    a = _angles(gen, c, B, torch.float32)
    if output == "features":
        cot = torch.rand((B, 30), generator=gen, device=cuda) * 2 - 1
    else:
        cot = torch.randn((B, c.dim), generator=gen, device=cuda, dtype=torch.complex64)
    before = K1.launch_counts()
    got = K1.circuit_vjp(c, a, cot, output)
    torch.cuda.synchronize()
    key = "K1_vjp" if output == "features" else "K2_vjp"
    assert K1.launch_counts()[key] == before[key] + 1
    for r in (slice(0, rows), slice(B - rows, B)):
        want = K1.circuit_vjp_reference(c, a[r], cot[r], output)
        assert float((got[r] - want).abs().max()) <= 5e-5 * max(1.0, float(want.abs().max()))


@pytest.mark.parametrize("kernel_type", ["projected", "fidelity"])
def test_autodiff_step_runs_the_kernels_both_ways(cuda, kernel_type):
    """grad_method="autodiff" on the card: K1 (K2) forward and the adjoint
    backward, one launch each, and the gradient of the CPU's plain run. The
    circuit is chebyshev for both kernels: kyriienko's fidelity Gram does
    not depend on the parameters here (its float64 gradient is ~1e-14), so
    its float32 gradients are noise."""
    import numpy as np

    from dqgp_tpu_torch.parallel.consensus import autodiff_nll_and_grad, make_agent_batch

    spec, X, Y, splits = _cheb_problem(kernel_type, enc="chebyshev")
    z = torch.as_tensor(np.random.RandomState(3).uniform(0.2, 3.0, spec.num_parameters))
    K1.reset_launch_counts()
    got = autodiff_nll_and_grad(spec, make_agent_batch(splits, cuda), z.to(cuda), 0.1).grad
    counts = K1.launch_counts()
    fwd, bwd = ("K1", "K1_vjp") if kernel_type == "projected" else ("K2", "K2_vjp")
    assert counts[fwd] == counts[bwd] == 1 and sum(counts.values()) == 2
    want = autodiff_nll_and_grad(spec, make_agent_batch(splits, "cpu"), z, 0.1).grad
    assert float((got.cpu() - want).abs().max()) <= 1e-3 * float(want.abs().max())


def test_card_fidelity_features_go_through_k2_and_k4(cuda, monkeypatch):
    """K4 takes the angles: nothing on the card's path builds packed rows
    (fusion.packed_inputs raises if anything calls it)."""
    from dqgp_tpu_torch.ops import fusion

    c = build_circuit("kyriienko", 6, 1, 1)
    spec = QuantumKernelSpec(circuit=c, kernel_type="fidelity")
    a = torch.zeros((4, c.num_gates), device=cuda)
    K1.reset_launch_counts()
    TQ.features_from_angles(spec, a)
    TQ.features_from_angles(spec, a.double())
    monkeypatch.setattr(config, "use_fusion", "on")

    def no_packed_rows(*args):
        raise AssertionError("packed rows built on the card's path")

    monkeypatch.setattr(fusion, "packed_inputs", no_packed_rows)
    monkeypatch.setattr(fusion, "su2_products", no_packed_rows)
    TQ.features_from_angles(spec, a)
    assert K1.launch_counts() == {"K1": 0, "K1_f64": 0, "K2": 1, "K2_f64": 1, "K3": 0,
                                  "K4": 1, "K1_vjp": 0, "K2_vjp": 0, "eig": 0,
                                  "eig_grams": 0, "eig_eigvalsh_grams": 0,
                                  "pair_contract": 0}


@pytest.mark.parametrize("enc", ENCODING_TYPES)
def test_fused_features_kernel_matches_plain_on_card(cuda, enc):
    """K3 at 8e-6 (tests/test_fusion.py) against the plain fused engine and
    K1's plain unfused version, for every qubit count it is built for (both
    sides of the register/lane split, and a sample across 2 and 4 warps at
    11 and 12), one launch a call."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    for n in range(1, K1.MAX_QUBITS["K3"] + 1):
        c = build_circuit(enc, n, 2, 2)
        for B in (1, 257):
            a = _angles(gen, c, B, torch.float32)
            before = K1.launch_counts()["K3"]
            got = K1.pauli_features_from_angles_fused(c, a)
            torch.cuda.synchronize()
            assert K1.launch_counts()["K3"] == before + 1
            assert got.shape == (B, 3 * n) and got.dtype == torch.float32
            assert float((got - K1.pauli_features_fused_reference(c, a)).abs().max()) <= 8e-6
            assert float((got - K1.pauli_features_reference(c, a)).abs().max()) <= 8e-6


def test_card_fused_projected_features_go_through_k3(cuda, monkeypatch):
    """Per-qubit projected features take K3 where fusion is on (at 10 qubits
    under "auto"), K1 where it is off, and K1's float64 instantiation for
    float64 angles whatever the switch says."""
    c = build_circuit("chebyshev", 10, 2, 2)
    spec = QuantumKernelSpec(circuit=c, kernel_type="projected")
    a = torch.zeros((4, c.num_gates), device=cuda)
    K1.reset_launch_counts()
    monkeypatch.setattr(config, "use_fusion", "auto")
    TQ.features_from_angles(spec, a)
    TQ.features_from_angles(spec, a.double())
    monkeypatch.setattr(config, "use_fusion", "off")
    TQ.features_from_angles(spec, a)
    assert K1.launch_counts() == {"K1": 1, "K1_f64": 1, "K2": 0, "K2_f64": 0, "K3": 1,
                                  "K4": 0, "K1_vjp": 0, "K2_vjp": 0, "eig": 0,
                                  "eig_grams": 0, "eig_eigvalsh_grams": 0,
                                  "pair_contract": 0}


def _cheb_problem(kernel_type="projected", n=60, agents=2, qubits=3, enc=None):
    import contextlib
    import io

    import numpy as np

    from dqgp_tpu_torch.data import split_data_numpy

    enc = enc or ("chebyshev" if kernel_type == "projected" else "kyriienko")
    spec = QuantumKernelSpec(circuit=build_circuit(enc, qubits, 2, 1), kernel_type=kernel_type,
                             outer_kernel="matern")
    rng = np.random.RandomState(0)
    X = rng.uniform(-0.99, 0.99, (n, 2))
    Y = np.sin(3 * X[:, 0]) * np.cos(2 * X[:, 1]) + 0.1 * rng.randn(n)
    with contextlib.redirect_stdout(io.StringIO()):
        splits = split_data_numpy(X, Y, agents, "regional")
    return spec, X, Y, splits


@pytest.mark.parametrize("kernel_type,kernel", [("projected", "K1"), ("fidelity", "K2")])
def test_chained_dispatch_replays_one_cuda_graph(cuda, kernel_type, kernel):
    """chain_iters=3 over 7 iterations: one capture after a warm-up, three
    replays (the last stops inside its chunk), each launching the path's
    kernel once a step and once a CV pass; z, theta and psi bit for bit the
    per-iteration loop's."""
    import numpy as np

    from dqgp_tpu_torch.driver import TrainConfig, train

    spec, X, Y, splits = _cheb_problem(kernel_type)
    kw = dict(cv_folds=3, verbose=False, max_iter=7)
    a = train(spec, splits, X, Y, TrainConfig(**kw), device=cuda)
    K1.reset_launch_counts()
    b = train(spec, splits, X, Y, TrainConfig(chain_iters=3, **kw), device=cuda)
    assert (b.iterations, b.converged_by) == (a.iterations, a.converged_by) == (7, "max_iter")
    for f in ("z", "theta", "psi"):
        np.testing.assert_array_equal(getattr(b, f), getattr(a, f), err_msg=f)
    for ha, hb in zip(a.cv_history, b.cv_history):
        np.testing.assert_array_equal(hb["consensus_params"], ha["consensus_params"])
        np.testing.assert_allclose(hb["consensus_cv_score"], ha["consensus_cv_score"], rtol=1e-12)
    st = b.chain_stats
    assert st["captured"] and st["replays"] == 3
    assert st["launches_per_replay"] == {kernel: 6}
    assert st["graph_pool_peak_bytes"] > 0
    # the wrappers counted the warm-up (2 calls) and the capture (6), not the replays
    assert K1.launch_counts()[kernel] == 2 + 6


def test_host_condition_numbers_on_card_match_the_cpu(cuda):
    """The float64 backfill through K1's float64 kernel against the plain
    complex128 engine on the CPU."""
    import numpy as np

    from dqgp_tpu_torch.driver import host_condition_numbers

    spec, X, Y, splits = _cheb_problem()
    Z = np.random.RandomState(1).uniform(0, np.pi, (18, spec.num_parameters)).round(4)
    K1.reset_launch_counts()
    got = host_condition_numbers(spec, splits, Z, device=cuda)
    assert K1.launch_counts()["K1_f64"] == 2 * 2  # agents x 16-row chunks
    np.testing.assert_allclose(got, host_condition_numbers(spec, splits, Z, device="cpu"),
                               rtol=1e-6)


@pytest.mark.parametrize("enc", ENCODING_TYPES)
def test_f64_kernels_hold_large_angles_on_card(cuda, enc):
    """K1's and K2's float64 kernels (the register layout, warp_state.cuh's
    float64 sin_cos) at 1e-12 of their plain versions with angles of
    +-1e6, +-1e15, +-1e300, 2^31 and next to multiples of pi/2 among the
    random ones, for every qubit count each is built for (K1 1-12, K2 1-10)."""
    import numpy as np

    gen = torch.Generator(device=cuda).manual_seed(8)
    special = torch.tensor([1e6, -1e6, 1e15, -1e15, 1e300, -1e300, 2.0 ** 31,
                            np.pi / 2, np.pi, -3 * np.pi, np.nextafter(np.pi, 4.0),
                            1e5 * np.pi], dtype=torch.float64, device=cuda)
    for n in range(1, K1.MAX_QUBITS["K1"] + 1):
        c = build_circuit(enc, n, 2, 2)
        a = _angles(gen, c, 130, torch.float64)
        flat = a.view(-1)
        k = flat[::3].numel()
        flat[::3] = special.repeat(k // len(special) + 1)[:k]
        got_f = K1.pauli_features_from_angles(c, a)
        torch.cuda.synchronize()
        assert float((got_f - K1.pauli_features_reference(c, a)).abs().max()) <= 1e-12
        if n <= K1.MAX_QUBITS["K2"]:
            got_s = K1.states_from_angles(c, a)
            torch.cuda.synchronize()
            assert float((got_s - K1.states_reference(c, a)).abs().max()) <= 1e-12


@pytest.mark.parametrize("method", ["momentum", "conjugate_gradient"])
def test_riemannian_optimizer_steps_on_card(cuda, method):
    """RiemannianOptimizer on points on the card: its state follows them
    there, and the steps are the CPU's."""
    import numpy as np

    from dqgp_tpu_torch import manifold as M

    on_card, on_cpu = (M.RiemannianOptimizer(M.TorusManifold(9), method=method)
                       for _ in range(2))
    rng = np.random.RandomState(5)
    x = rng.uniform(0, np.pi, 9)
    xc, xh = torch.as_tensor(x, device=cuda), torch.as_tensor(x)
    for k in range(4):
        g = rng.randn(9) * (10.0 if k % 2 else 0.05)
        xc = on_card.step(xc, torch.as_tensor(g, device=cuda))
        xh = on_cpu.step(xh, torch.as_tensor(g))
        assert xc.device == cuda and all(t.device == cuda for t in on_card.state)
        np.testing.assert_allclose(xc.cpu().numpy(), xh.numpy(), rtol=0, atol=1e-12)


def test_flag_solve_is_captured(cuda):
    """solve_psd_with_fallback(fallback=False) in a CUDA graph: a replay on
    new inputs equals the eager solve, a failed member reads NaN."""
    from dqgp_tpu_torch.ops.linalg import solve_psd_with_fallback

    gen = torch.Generator(device=cuda).manual_seed(4)
    A = torch.randn((3, 20, 20), generator=gen, device=cuda, dtype=torch.float64)
    C = A @ A.transpose(-1, -2) + torch.eye(20, device=cuda, dtype=torch.float64)
    y = torch.randn((3, 20), generator=gen, device=cuda, dtype=torch.float64)
    C_in, y_in = C.clone(), y.clone()
    stream = torch.cuda.Stream(cuda)
    stream.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(stream):
        solve_psd_with_fallback(C_in, y_in, fallback=False)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, stream=stream):
        out = solve_psd_with_fallback(C_in, y_in, fallback=False)
    C2 = C.clone()
    C2[1] = -C2[1]                      # not positive definite
    C_in.copy_(C2)
    g.replay()
    torch.cuda.synchronize()
    want = solve_psd_with_fallback(C2, y, fallback=False)
    assert bool(torch.isnan(out.logdet[1])) and not bool(out.chol_ok[1])
    torch.testing.assert_close(out.C_inv_y[[0, 2]], want.C_inv_y[[0, 2]], rtol=0, atol=0)


def test_eigvalsh_cannot_be_captured(cuda):
    """Why cond_mode="device" with chain_iters > 1 is refused on CUDA:
    torch's eigvalsh checks its info on the host, which a capture forbids."""
    C = torch.eye(8, device=cuda, dtype=torch.float64).expand(2, 8, 8).contiguous()
    stream = torch.cuda.Stream(cuda)
    stream.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(stream):
        torch.linalg.eigvalsh(C)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError):
        with torch.cuda.graph(g, stream=stream):
            torch.linalg.eigvalsh(C)


# ---------------------------------------------------------------------------
# the batched eigenvalue kernel (ops/cuda_eig.py) against eigvalsh
# ---------------------------------------------------------------------------

_BUCKETS = (1e8, 1e12, 1e15)


def _conds(ext):
    return (ext[:, 0] / torch.clamp(ext[:, 1], min=torch.finfo(torch.float64).tiny)).cpu()


def _hold_conds(got, want, what=""):
    """rtol 1e-6 below 1e8, the same bucket (1e8 / 1e12 / 1e15) above: the
    benchmark's ``cond`` bar at a tenth of its limit."""
    import numpy as np

    def bucket(c):
        return sum(c >= b for b in _BUCKETS) if np.isfinite(c) else len(_BUCKETS)

    for g, w in zip(np.ravel(got), np.ravel(want)):
        if w < _BUCKETS[0]:
            assert abs(g - w) <= 1e-6 * w, (what, g, w)
        else:
            assert bucket(g) == bucket(w), (what, g, w)


def _hold_extremes(got, want, n):
    """max|w| at rtol 1e-10, and min|w| within n * eps * max|w| of eigvalsh's
    (``n`` the rows of each Gram): both methods are backward stable on the
    same float64 Gram. Above a condition number of 1e8 this holds the small
    end, which the bucket does not."""
    n = torch.as_tensor(n, dtype=torch.float64, device=got.device)
    torch.testing.assert_close(got[:, 0], want[:, 0], rtol=1e-10, atol=0)
    bar = n * torch.finfo(torch.float64).eps * want[:, 0]
    assert bool(((got[:, 1] - want[:, 1]).abs() <= bar).all()), (
        ((got[:, 1] - want[:, 1]).abs() / bar).max())


def _spectrum_grams(gen, n, spectra, device):
    """Q diag(w) Q^T for each spectrum w (n values), Q a seeded orthogonal."""
    Q, _ = torch.linalg.qr(torch.randn((len(spectra), n, n), generator=gen, device=device,
                                       dtype=torch.float64))
    W = torch.stack([torch.as_tensor(w, dtype=torch.float64, device=device) for w in spectra])
    A = (Q * W[:, None, :]) @ Q.transpose(-1, -2)
    return 0.5 * (A + A.transpose(-1, -2))


def _northstar():
    import contextlib
    import io
    import json
    from pathlib import Path

    import numpy as np

    import chip_smoke as cs
    from dqgp_tpu_torch.data import split_data_numpy

    ref = json.loads((Path(__file__).resolve().parent / "fixtures"
                      / "torch_port_northstar.json").read_text())
    X, Y, _, _ = cs.make_problem()
    with contextlib.redirect_stdout(io.StringIO()):
        splits = split_data_numpy(X, Y, cs.N_AGENTS, "regional")
    return cs.northstar_spec(), splits, np.array(ref["z_trajectory"])


def test_eig_kernel_layout_matches_the_wrapper(cuda):
    """The kernel's shared-memory layout is the wrapper's, and a cluster of
    each size fits the card at its limit."""
    from dqgp_tpu_torch.ops import cuda_eig as E

    lib = E._library()
    for C in E.CLUSTER_SIZES:
        for n in (1, 2, 31, 33, 225, 238, 260, E.cluster_limit(C)):
            assert lib.dqgp_gram_extremes_smem_bytes(n, C) == E.smem_bytes(n, C)
        assert lib.dqgp_gram_extremes_max_clusters(C, E.smem_bytes(E.cluster_limit(C), C)) >= 1


def test_eig_kernel_every_size_on_card(cuda):
    """Every n from 1 to the kernel's limit, one launch an n (so every
    cluster size): a positive definite spectrum (condition number 1e6) and
    an indefinite one whose least |w| is a small negative eigenvalue."""
    import numpy as np

    from dqgp_tpu_torch.ops import cuda_eig as E

    gen = torch.Generator(device=cuda).manual_seed(9)
    K1.reset_launch_counts()
    for n in range(1, E.MAX_N + 1):
        pos = np.geomspace(1.0, 1e-6, n)
        ind = np.linspace(-1.0, 2.0, n)
        ind[n // 2] = -1e-4
        G = _spectrum_grams(gen, n, [pos, ind], cuda)
        got, want = E.gram_extremes([G]), E.gram_extremes_reference(G)
        _hold_extremes(got, want, n)
        _hold_conds(_conds(got), _conds(want), f"n {n}")
    counts = K1.launch_counts()
    assert (counts["eig"], counts["eig_grams"], counts["eig_eigvalsh_grams"]) == (
        E.MAX_N, 2 * E.MAX_N, 0)


def test_eig_kernel_on_a_ragged_northstar_chunk(cuda):
    """A backfill chunk of the north star: 16 z rows x 4 agents of 238-260
    rows, 64 Grams of 4 sizes in one launch of clusters of two."""
    import numpy as np

    from dqgp_tpu_torch import manifold as M
    from dqgp_tpu_torch.models.kernels.quantum_kernel import grams_at_rows
    from dqgp_tpu_torch.ops import cuda_eig as E

    spec, splits, Z = _northstar()
    rng = np.random.RandomState(2)
    rows = M.wrap(torch.as_tensor(Z[rng.randint(len(Z), size=16)]
                                  + rng.uniform(-0.05, 0.05, (16, Z.shape[1])), device=cuda))
    grams = [grams_at_rows(spec, torch.as_tensor(X_i, device=cuda), rows) for X_i, _ in splits]
    assert sorted({g.shape[1] for g in grams}) == sorted(len(x) for x, _ in splits)
    K1.reset_launch_counts()
    got = E.gram_extremes(grams)
    assert K1.launch_counts()["eig"] == 1 and K1.launch_counts()["eig_grams"] == 64
    want = torch.cat([E.gram_extremes_reference(g) for g in grams])
    _hold_extremes(got, want, [g.shape[1] for g in grams for _ in range(g.shape[0])])
    _hold_conds(_conds(got), _conds(want))


def test_eig_backfill_matches_the_eigvalsh_path_on_card(cuda, monkeypatch):
    """host_condition_numbers on the north star's fixture z: one launch a
    16-row chunk for all four agents, against the eigvalsh path (an agent a
    call, every Gram counted as sent to eigvalsh)."""
    import numpy as np

    from dqgp_tpu_torch.driver import host_condition_numbers
    from dqgp_tpu_torch.ops import cuda_eig as E

    spec, splits, Z = _northstar()
    rows = np.concatenate([Z + 0.01 * k for k in range(4)])  # 20 rows: 2 chunks
    K1.reset_launch_counts()
    got = host_condition_numbers(spec, splits, rows, device=cuda)
    counts = K1.launch_counts()
    assert (counts["eig"], counts["eig_grams"], counts["eig_eigvalsh_grams"]) == (2, 80, 0)
    monkeypatch.setattr(E, "MAX_N", 0)
    K1.reset_launch_counts()
    want = host_condition_numbers(spec, splits, rows, device=cuda)
    counts = K1.launch_counts()
    assert (counts["eig"], counts["eig_grams"], counts["eig_eigvalsh_grams"]) == (0, 0, 80)
    assert got.shape == want.shape == (20, 4)
    _hold_conds(got, want)


def test_eig_kernel_on_a_non_finite_gram(cuda, monkeypatch):
    """A Gram with a NaN or an inf entry: eigvalsh on the card raises
    LinAlgError or reads NaN; the kernel reads NaN for both extremes and
    leaves the Grams beside it in the launch as they are; the backfill of a
    z row with a NaN raises on both paths."""
    import numpy as np

    from dqgp_tpu_torch.driver import host_condition_numbers
    from dqgp_tpu_torch.ops import cuda_eig as E

    gen = torch.Generator(device=cuda).manual_seed(5)
    for n in (6, 240):
        G = _spectrum_grams(gen, n, [[1.0 + k / n for k in range(n)]] * 3, cuda)
        G[1, 3, 1] = G[1, 1, 3] = float("nan")
        G[2, n - 1, n - 1] = float("inf")
        for bad in (G[1:2], G[2:3]):  # eigvalsh raises or reads NaN, never a number
            try:
                assert torch.isnan(_conds(E.gram_extremes_reference(bad))).all()
            except torch.linalg.LinAlgError:
                pass
        got = E.gram_extremes([G])
        assert torch.isnan(got[1:]).all()
        _hold_extremes(got[:1], E.gram_extremes_reference(G[:1]), n)
    spec, splits, Z = _northstar()
    rows = Z[:2].copy()
    rows[1, 3] = np.nan
    with pytest.raises(torch.linalg.LinAlgError):
        host_condition_numbers(spec, splits, rows, device=cuda)
    monkeypatch.setattr(E, "MAX_N", 0)
    with pytest.raises(torch.linalg.LinAlgError):
        host_condition_numbers(spec, splits, rows, device=cuda)


def test_each_launch_is_one_span_on_card(cuda):
    """Under the profiler every hand-kernel launch records one span
    ``cuda_circuit.launch:<key>`` (its ``launch_counts()`` key), in the
    order of the launches, and none without the profiler."""
    from torch.profiler import ProfilerActivity, profile

    from dqgp_tpu_torch import tracing

    gen = torch.Generator(device=cuda).manual_seed(5)
    c4, c6, c10 = (build_circuit("chebyshev", n, 2, 2) for n in (4, 6, 10))

    def launch_all():
        K1.pauli_features_from_angles(c4, _angles(gen, c4, 64, torch.float32))
        K1.pauli_features_from_angles(c4, _angles(gen, c4, 64, torch.float64))
        K1.pauli_features_from_angles_fused(c10, _angles(gen, c10, 64, torch.float32))
        K1.states_from_angles(c6, _angles(gen, c6, 64, torch.float32))
        K1.states_from_angles_fused(c6, _angles(gen, c6, 64, torch.float32))
        K1.circuit_vjp(c6, _angles(gen, c6, 64, torch.float32),
                       torch.ones((64, 18), device=cuda), "features")
        torch.cuda.synchronize()
        return ["K1", "K1_f64", "K3", "K2", "K4", "K1_vjp"]

    launch_all()  # builds and loads every library outside the profile
    before = len(tracing.spans())
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        keys = launch_all()
    names = [s.name for s in tracing.spans()[before:] if s.name.startswith("cuda_circuit.")]
    assert names == [f"cuda_circuit.launch:{k}" for k in keys]
    n = len(tracing.spans())
    launch_all()
    assert len(tracing.spans()) == n


def test_wide_launches_are_counted_on_card(cuda):
    """A launch of an 11- or 12-qubit instantiation counts in
    ``wide_launch_counts()`` as well as in ``launch_counts()``; one at 10
    qubits only in the latter."""
    gen = torch.Generator(device=cuda).manual_seed(6)
    c10, c11, c12 = (build_circuit("chebyshev", n, 2, 2) for n in (10, 11, 12))
    K1.reset_launch_counts()
    try:
        K1.pauli_features_from_angles_fused(c10, _angles(gen, c10, 40, torch.float32))
        K1.pauli_features_from_angles(c10, _angles(gen, c10, 40, torch.float32))
        torch.cuda.synchronize()
        assert K1.wide_launch_counts() == {"K1": 0, "K1_f64": 0, "K3": 0}
        K1.pauli_features_from_angles_fused(c12, _angles(gen, c12, 40, torch.float32))
        K1.pauli_features_from_angles(c11, _angles(gen, c11, 40, torch.float32))
        K1.pauli_features_from_angles(c12, _angles(gen, c12, 40, torch.float64))
        torch.cuda.synchronize()
        assert K1.wide_launch_counts() == {"K1": 1, "K1_f64": 1, "K3": 1}
        counts = K1.launch_counts()
        assert (counts["K1"], counts["K1_f64"], counts["K3"]) == (2, 1, 2)
        assert sum(counts.values()) == 5
    finally:
        K1.reset_launch_counts()
    assert K1.wide_launch_counts() == {"K1": 0, "K1_f64": 0, "K3": 0}


@pytest.mark.parametrize("n", [11, 12])
def test_wide_fused_phase_runs_match_plain_on_card(cuda, n):
    """K3 at 11 and 12 qubits, where each lane builds a phase run's phases
    from its polynomial over the register bits, against the plain fused
    engine at chip_smoke.py's K1_TOL, on ``chip_smoke.every_kind_circuit``:
    phase runs of RZ, CRZ, CZ and RZZ members on register, lane and warp
    bits. The angles are whole numbers, and every other member angle of the
    runs without a CZ is +-2^18: those runs' phases pass 105,615, where
    sin_cos takes the Payne-Hanek path, and every order of their sums is
    exact (a CZ's pi stays in runs of small phases). Each call is one
    launch, counted as wide."""
    import numpy as np

    import chip_smoke as cs
    from dqgp_tpu_torch.ops import fusion as tf

    c = cs.every_kind_circuit(n)
    runs = [op for op in tf.fuse_circuit(c).ops if isinstance(op, tf.DiagOp)]
    members = [m for op in runs for m in op.members]
    assert {kind for kind, *_ in members} == {2, 5, 8, 9}  # RZ, CZ, CRZ, RZZ
    bits = {b for _, q, ctl, _ in members for b in (q, ctl) if b >= 0}
    assert min(bits) < 5 and any(5 <= b < 10 for b in bits) and max(bits) >= 10
    large = [gi for op in runs if all(kind != 5 for kind, *_ in op.members)
             for _, _, _, gi in op.members[::2]]
    gen = torch.Generator(device=cuda).manual_seed(9)
    for B in (1, 131):
        a = torch.randint(-3, 10, (B, c.num_gates), generator=gen, device=cuda).float()
        sign = torch.randint(0, 2, (B, len(large)), generator=gen, device=cuda).float()
        a[:, large] = (2 * sign - 1) * 2.0 ** 18
        rows = a.double().cpu().numpy()
        phi = max(np.abs(np.where([gi < 0 for *_, gi in op.members], np.pi, rows[:, [
            max(gi, 0) for *_, gi in op.members]]) @ tf.diag_pattern(op, n).T).max()
            for op in runs)
        assert phi > 105615.0
        before = K1.launch_counts()["K3"], K1.wide_launch_counts()["K3"]
        got = K1.pauli_features_from_angles_fused(c, a)
        torch.cuda.synchronize()
        assert (K1.launch_counts()["K3"], K1.wide_launch_counts()["K3"]) == (
            before[0] + 1, before[1] + 1)
        assert got.shape == (B, 3 * n) and torch.isfinite(got).all()
        err = float((got - K1.pauli_features_fused_reference(c, a)).abs().max())
        assert err <= cs.K1_TOL


# the streamed gradient's contraction kernel (ops/cuda_pair.py) against its
# plain version, the loop's PyTorch arithmetic: within 1e-6 of the largest
# component (phase 11b's streamed = central bar), the sums' order apart

PAIR_TOL = 1e-6


def _pair_problem(cuda, qubits, sizes, measurement="XYZ", seed=0):
    """(spec, batch, z32, F, bracket, mask): agents of ``sizes`` rows of
    chebyshev ``qubits`` x 2, the bracket of their Grams at a random z, the
    features at parameter 0's +-h shift."""
    import numpy as np

    from dqgp_tpu_torch import manifold as M
    from dqgp_tpu_torch.models.gp.posterior import masked_nll_core
    from dqgp_tpu_torch.parallel import consensus as C

    rng = np.random.RandomState(seed)
    splits = [(rng.uniform(-1, 1, (n, 2)), rng.standard_normal(n)) for n in sizes]
    spec = QuantumKernelSpec(circuit=build_circuit("chebyshev", qubits, 2, 2),
                             kernel_type="projected", outer_kernel="matern",
                             measurement=measurement)
    batch = C.make_agent_batch(splits, cuda)
    P = spec.num_parameters
    z32 = torch.as_tensor(rng.uniform(0, M.PERIOD, P), dtype=torch.float32, device=cuda)
    F0 = C.agent_features(spec, batch.X, z32[None])
    mask = batch.mask.double()
    _, bracket = masked_nll_core(TQ.gram_from_features(spec, F0)[:, 0].double(), batch.Y, mask,
                                 0.1, compute_cond=False)
    h = torch.zeros(P, dtype=torch.float32, device=cuda)
    h[0] = 3.14159265358979 / 8
    pair = torch.remainder(torch.stack([z32 + h, z32 - h]), M.PERIOD)
    return spec, batch, z32, C.agent_features(spec, batch.X, pair), bracket.contiguous(), mask


def _config7_sizes(agents=64):
    import numpy as np

    sizes = np.random.RandomState(7).randint(717, 845, agents).tolist()
    sizes[3] = 844
    return sizes


def _pair_dev(got, want):
    return float((got - want).abs().max()) / float(want.abs().max())


# the kernel's error against g_p in float64 (the plain version on the
# features upcast) may be at most this multiple of the loop's: a bar that
# holds whatever order PyTorch's float32 sums take
PAIR_F64_RATIO = 2.0


def _hold_to_float64(got, want, F, bracket, mask, h, ls=1.0, nu=1.5):
    from dqgp_tpu_torch.ops import cuda_pair as CP

    exact = CP.shift_pair_contract_reference(F.double(), bracket, mask, h, ls, nu)
    kernel_err, loop_err = _pair_dev(got, exact), _pair_dev(want, exact)
    assert kernel_err <= max(PAIR_F64_RATIO * loop_err, 1e-12), (nu, kernel_err, loop_err)


@pytest.mark.parametrize("D", [1, 3, 9, 16, 30, 36, 63])
def test_torch_sums_a_feature_row_as_the_contraction_kernel_does(cuda, D):
    """The kernel's squared norms follow ``torch.sum(F * F, -1)`` on the
    card bit for bit (the Matern of nearly equal rows reads their ulps):
    lane x of W, the largest power of 2 <= D, adds products x and x + W,
    then the lanes add down at W / 2, ..., 1. A PyTorch whose reduction
    sums otherwise fails here first."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    F = torch.randn((3000, D), generator=gen, device=cuda)
    e = F * F
    W = 1 << (D.bit_length() - 1)
    p = e[:, :W].clone()
    p[:, : D - W] = p[:, : D - W] + e[:, W:D]
    o = W // 2
    while o > 0:
        p[:, :o] = p[:, :o] + p[:, o:2 * o]
        o //= 2
    got = torch.sum(e, dim=-1)
    assert torch.equal(p[:, 0], got), (
        F.dtype, got.dtype, int((p[:, 0] != got).sum()), bool(torch.isnan(F).any()),
        float((p[:, 0] - got).abs().max()))


@pytest.mark.parametrize("qubits,nus", [(10, (0.5, 1.5, 2.5, float("inf"))), (12, (1.5,))])
def test_pair_contract_at_config7_shapes_on_card(cuda, qubits, nus):
    """64 agents of 717-844 rows at 10 and 12 qubits: g_p within PAIR_TOL of
    the plain version for each nu and no further from g_p in float64 than
    PAIR_F64_RATIO times the plain version, a rerun bit for bit, one counted
    call."""
    from dqgp_tpu_torch.ops import cuda_pair as CP

    _, _, _, F, bracket, mask = _pair_problem(cuda, qubits, _config7_sizes())
    h = 3.14159265358979 / 8
    for nu in nus:
        before = K1.launch_counts()["pair_contract"]
        got = CP.shift_pair_contract(F, bracket, mask, h, 1.0, nu)
        again = CP.shift_pair_contract(F, bracket, mask, h, 1.0, nu)
        torch.cuda.synchronize()
        assert K1.launch_counts()["pair_contract"] == before + 2
        assert torch.equal(got, again)
        want = CP.shift_pair_contract_reference(F, bracket, mask, h, 1.0, nu)
        assert _pair_dev(got, want) <= PAIR_TOL
        _hold_to_float64(got, want, F, bracket, mask, h, 1.0, nu)


@pytest.mark.parametrize("sizes", [[1, 5, 64, 65, 130, 7], [63, 2, 64], [65, 65]])
@pytest.mark.parametrize("qubits,measurement", [(1, "XYZ"), (3, "XY"), (5, "XYZ"), (4, "Z")])
def test_pair_contract_at_small_ragged_shapes_on_card(cuda, sizes, qubits, measurement):
    """Ragged agents (an odd Nmax takes the scalar bracket loads), widths
    D = 3, 6, 15, 4, each nu and another length scale."""
    from dqgp_tpu_torch.ops import cuda_pair as CP

    _, _, _, F, bracket, mask = _pair_problem(cuda, qubits, sizes, measurement, seed=len(sizes))
    h = 3.14159265358979 / 8
    for nu in CP.NU_CODES:
        for ls in (1.0, 0.7):
            got = CP.shift_pair_contract(F, bracket, mask, h, ls, nu)
            want = CP.shift_pair_contract_reference(F, bracket, mask, h, ls, nu)
            assert _pair_dev(got, want) <= PAIR_TOL, (nu, ls)
            _hold_to_float64(got, want, F, bracket, mask, h, ls, nu)


def test_pair_contract_takes_every_width_in_any_order_on_card(cuda):
    """Random features at D = 63 (shared memory above the default 48 KB),
    then 9, then 63 again: each within PAIR_TOL of the plain version (the
    launch asks the occupancy once a width and keeps the widest limit)."""
    from dqgp_tpu_torch.ops import cuda_pair as CP

    gen = torch.Generator(device=cuda).manual_seed(5)
    sizes, N = [70, 130, 3], 130
    mask = torch.zeros((3, N), dtype=torch.float64, device=cuda)
    for a, n in enumerate(sizes):
        mask[a, :n] = 1.0
    B = torch.randn((3, N, N), generator=gen, dtype=torch.float64, device=cuda)
    for D in (CP.max_d(), 9, CP.max_d()):
        F = torch.rand((3, 2, N, D), generator=gen, device=cuda)
        got = CP.shift_pair_contract(F, B, mask, 0.39, 1.3, 2.5)
        want = CP.shift_pair_contract_reference(F, B, mask, 0.39, 1.3, 2.5)
        assert _pair_dev(got, want) <= PAIR_TOL, D


def test_pair_contract_nan_in_a_real_row_reaches_its_agent(cuda):
    from dqgp_tpu_torch.ops import cuda_pair as CP

    _, _, _, F, bracket, mask = _pair_problem(cuda, 4, [90, 70, 80])
    h = 3.14159265358979 / 8
    g = CP.shift_pair_contract(F, bracket, mask, h)
    for sign, value in ((0, float("nan")), (1, float("inf"))):
        Fn = F.clone()
        Fn[1, sign, 33, 2] = value
        gn = CP.shift_pair_contract(Fn, bracket, mask, h)
        want = CP.shift_pair_contract_reference(Fn, bracket, mask, h)
        assert bool(torch.isnan(gn[1])) and bool(torch.isnan(want[1]))
        assert torch.equal(gn[[0, 2]], g[[0, 2]])
    Bn = bracket.clone()
    Bn[2, 5, 60] = float("nan")
    gb = CP.shift_pair_contract(F, Bn, mask, h)
    assert bool(torch.isnan(gb[2])) and torch.equal(gb[:2], g[:2])


def test_streamed_step_takes_the_kernel_once_a_parameter_on_card(cuda, monkeypatch):
    """The streamed gradient on the card: P contraction calls, within
    PAIR_TOL of the loop's gradient (the kernel's path refused), and of
    the central one."""
    from dqgp_tpu_torch.models.gp.posterior import masked_nll_and_grad
    from dqgp_tpu_torch.ops import cuda_pair as CP
    from dqgp_tpu_torch.parallel import consensus as C

    spec, batch, z32, _, _, _ = _pair_problem(cuda, 10, [300, 257, 190])
    h = 3.14159265358979 / 8
    K1.reset_launch_counts()
    got = C.streamed_nll_and_grad(spec, batch, z32, h, 0.1, compute_cond=False)
    torch.cuda.synchronize()
    counts = K1.launch_counts()
    P = spec.num_parameters
    assert counts["pair_contract"] == P and counts["K3"] == 1 + P
    monkeypatch.setattr(CP, "takes_kernel", lambda *args: False)
    loop = C.streamed_nll_and_grad(spec, batch, z32, h, 0.1, compute_cond=False)
    assert K1.launch_counts()["pair_contract"] == P
    assert _pair_dev(got.grad, loop.grad) <= PAIR_TOL
    assert torch.equal(got.nll, loop.nll)
    Kc, dKc = TQ.gram_and_shift_grads(spec, batch.X, z32, h)
    central = masked_nll_and_grad(Kc.double(), dKc, batch.Y, batch.mask, 0.1,
                                  compute_cond=False)
    assert _pair_dev(got.grad, central.grad) <= PAIR_TOL


def test_pair_contract_launch_is_one_span_on_card(cuda):
    from torch.profiler import ProfilerActivity, profile

    from dqgp_tpu_torch import tracing
    from dqgp_tpu_torch.ops import cuda_pair as CP

    _, _, _, F, bracket, mask = _pair_problem(cuda, 3, [40, 30])
    CP.shift_pair_contract(F, bracket, mask, 0.39)
    torch.cuda.synchronize()
    before = len(tracing.spans())
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        CP.shift_pair_contract(F, bracket, mask, 0.39)
        torch.cuda.synchronize()
    names = [s.name for s in tracing.spans()[before:] if s.name.startswith("cuda_circuit.")]
    assert names == ["cuda_circuit.launch:pair_contract"]
    kernels = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    assert any("shift_pair_contract_kernel" in k for k in kernels), kernels


def test_chained_streamed_training_replays_the_contraction_on_card(cuda):
    """grad_method="streamed" with chain_iters=3 on the Matern path: the
    contraction's launches captured in the CUDA graph (P calls a step), z,
    theta and psi bit for bit the eager run's."""
    import numpy as np

    from dqgp_tpu_torch.driver import TrainConfig, train

    spec, X, Y, splits = _cheb_problem()
    P = spec.num_parameters
    kw = dict(cv_folds=3, verbose=False, max_iter=7, grad_method="streamed")
    K1.reset_launch_counts()
    a = train(spec, splits, X, Y, TrainConfig(**kw), device=cuda)
    assert K1.launch_counts()["pair_contract"] == 7 * P
    b = train(spec, splits, X, Y, TrainConfig(chain_iters=3, **kw), device=cuda)
    assert (b.iterations, b.converged_by) == (a.iterations, a.converged_by) == (7, "max_iter")
    for f in ("z", "theta", "psi"):
        np.testing.assert_array_equal(getattr(b, f), getattr(a, f), err_msg=f)
    st = b.chain_stats
    assert st["captured"] and st["replays"] == 3
    # a step: the features at z and at each parameter's +-h, then the CV pass
    assert st["launches_per_replay"] == {"K1": 3 * (P + 2), "pair_contract": 3 * P}
