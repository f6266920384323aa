#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``dqgp_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, one line each; any failure raises and exits non-zero:

1. device  — the card's name and power limit (nvidia-smi);
2. build   — nvcc builds the Pauli-feature (K1), states (K2) and fused
             states (K4) kernels for sm_90a, one nvcc each, all started
             together, with ptxas's register and spill report;
3. K1      — the kernel against its plain PyTorch version on the same CUDA
             tensors: 8 circuit families x {2,3,4,5,8,10} qubits x batch
             {1, 130, 84240}, plus the main path's own shapes (chebyshev
             4 qubits / 3 layers, G=40, at B = 84240 step rows, 1000 CV and
             predict-train rows, 200 predict-test rows), max abs diff <= 5e-6;
4. main    — the north-star problem (bench.py:52-77: N=1000 2-D inputs,
             chebyshev 4 qubits / 3 layers, projected Matérn-1.5 kernel,
             4 regional agents, rho=L=100) trained for 5 ADMM iterations with
             per-iteration 5-fold CV through ``train(..., device=cuda)``,
             then ``predict_quantum_gp`` + ``evaluate_predictions`` on 200
             held-out rows. K1 must have run in every step, CV pass and
             predict; the z trajectory must stay within 5e-3 and every CV and
             test NLPD within 0.05 of the JAX float64 reference
             (tests/fixtures/torch_port_northstar.json);
5. times   — CUDA-event times of one ADMM iteration (step + CV), of K1 vs
             its plain version at B=84240, G=40, n=4, and of the projected
             1000x1000 Gram;
6. states  — K2 (float32 <= 2e-6, float64 <= 1e-12), K1's float64
             instantiation (<= 1e-12) and K4 (<= 3e-6 against the plain fused
             engine and against the plain unfused states) on the same CUDA
             tensors: 8 families x {2,3,4,6,8,10} qubits x batch
             {1, 130, 22500}, plus the fidelity path's shapes (kyriienko
             6 qubits / 1 layer, G=23, at 22500 step rows, 900 CV and
             predict-train rows, 100 predict-test rows);
7. fidelity — BASELINE config #5 (kyriienko 6 qubits / 1 layer, fidelity
             kernel) at the reference's 1-D size: the synthetic dataset
             generated on the card (its float64 Gram through K2's float64
             instantiation; Y within 1e-6 of the JAX float64 dataset), the
             CLI's train/test split and regional partition over 4 agents,
             5 ADMM iterations with 5-fold CV, predict and evaluate. K2 must
             have run in every step, CV pass and predict; z within 5e-3,
             every agent NLL within rtol 1e-4, every CV-NLPD and the test
             NLPD within max(0.05, 2 |JAX f32 - JAX f64|) of the JAX float32
             values (tests/fixtures/torch_port_fidelity.json);
8. fused   — the same training for 2 iterations with fusion on: K4 runs in
             K2's place, under the same bars;
9. times   — one fidelity ADMM iteration (step + CV), K2 vs plain and K4 vs
             plain fused at B=22500, G=23, n=6, K2 vs K4 at 6 and 10 qubits,
             K2 float64 vs plain complex128 at B=1000, and the 900x900
             fidelity Gram.

The last two lines are a JSON record of the kernels and
``{"ok": true, "device": {...}}``. The script imports nothing of JAX.
"""

import hashlib
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "torch_port_northstar.json")

# The north-star problem (bench.py:52-77) plus held-out test rows.
N_SAMPLES, N_TEST, N_AGENTS = 1000, 200, 4
NUM_QUBITS, NUM_FEATURES, NUM_LAYERS = 4, 2, 3
ITERS = 5
Z_TOL = 5e-3      # bench.py:59-60: z rounds to 4 dp each iteration; the bars
NLPD_TOL = 0.05   # cover last-digit flips, not a numerics divergence
K1_TOL = 5e-6     # float32 features, as tests/test_pallas_circuit.py holds them
K1_QUBITS = (2, 3, 4, 5, 8, 10)
STEP_ROWS = 4 * 81 * 260  # K1's batch in one step: agents x (2P+1) shifts x Nmax
K1_BATCHES = (1, 130, 84240)

# The fidelity-kernel problem: BASELINE config #5 (a 6-qubit, 1-layer
# kyriienko fidelity kernel on a synthetic quantum-GP dataset) at the
# reference's recommended 1-D size (cli.py:338), split and partitioned as
# cli.py:342-378 does.
FID_SAMPLES, FID_TEST_SPLIT, FID_AGENTS, FID_SEED = 1000, 0.1, 4, 42
FID_QUBITS, FID_LAYERS = 6, 1
FID_ITERS, FID_FUSED_ITERS = 5, 2
FID_STEP_ROWS = 4 * 25 * 225  # K2's batch in one step: agents x (2P+1) x Nmax
STATES_QUBITS = (2, 3, 4, 6, 8, 10)
STATES_BATCHES = (1, 130, FID_STEP_ROWS)
K2_TOL = 2e-6     # float32 states, as tests/test_pallas_circuit.py holds them
F64_TOL = 1e-12   # float64 states and features, as tests/test_native.py
K4_TOL = 3e-6     # fused float32 states, as tests/test_fusion.py
NLL_RTOL = 1e-4
FIDELITY_FIXTURE = os.path.join(REPO, "tests", "fixtures", "torch_port_fidelity.json")


def array_digest(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a, np.float64).tobytes()).hexdigest()


def make_problem():
    """Seeded north-star data: (X, Y, X_test, Y_test) as float64 numpy."""
    rng = np.random.RandomState(0)
    X = rng.uniform(-0.99, 0.99, (N_SAMPLES, 2))
    Y = np.sin(3 * X[:, 0]) * np.cos(2 * X[:, 1]) + 0.1 * rng.randn(N_SAMPLES)
    X_test = rng.uniform(-0.99, 0.99, (N_TEST, 2))
    Y_test = (np.sin(3 * X_test[:, 0]) * np.cos(2 * X_test[:, 1])
              + 0.1 * rng.randn(N_TEST))
    return X, Y, X_test, Y_test


def problem_digest(X, Y, X_test, Y_test) -> str:
    h = hashlib.sha256()
    for a in (X, Y, X_test, Y_test):
        h.update(np.ascontiguousarray(a, np.float64).tobytes())
    return h.hexdigest()


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise AssertionError(msg)


def _cuda_time_ms(fn, reps: int) -> float:
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _alternate_ms(fns, reps: int):
    """Times of each fn in ``fns`` (ms), measured in turns a, b, ..., b, a
    after one warm-up call each; returns the mean of the two turns."""
    for f in fns:
        f()
    first = [_cuda_time_ms(f, reps) for f in fns]
    second = [_cuda_time_ms(f, reps) for f in reversed(fns)][::-1]
    return [(a + b) / 2 for a, b in zip(first, second)]


def build_kernels(sources):
    """Build every source with its own nvcc, all started together; returns
    one report line per source (time and ptxas's register/spill lines)."""
    from dqgp_tpu_torch.ops import _build

    def one(src):
        t0 = time.time()
        lib_path, log = _build.build(src)
        info = [ln.split(":", 1)[-1].strip() for ln in log.splitlines()
                if "registers" in ln or "spill" in ln]
        return (f"{src} -> {os.path.basename(lib_path)} in {time.time() - t0:.2f} s "
                f"[{'; '.join(info) if info else 'reused'}]")

    with ThreadPoolExecutor(len(sources)) as pool:
        return list(pool.map(one, sources))


def fidelity_problem(dev):
    """Config #5's dataset generated on ``dev``, split and partitioned as
    cli.py:342-378 does. Returns (spec, X, Y, theta*, X_tr, Y_tr, X_te,
    Y_te, splits)."""
    import contextlib
    import io

    from dqgp_tpu_torch.data import (
        generate_quantum_gp_data, split_data_numpy, train_test_split_np)
    from dqgp_tpu_torch.models.circuits import build_circuit
    from dqgp_tpu_torch.models.kernels import QuantumKernelSpec

    spec = QuantumKernelSpec(
        circuit=build_circuit("kyriienko", FID_QUBITS, 1, FID_LAYERS),
        kernel_type="fidelity")
    X, Y, theta = generate_quantum_gp_data(
        FID_SAMPLES, 1, spec, data_seed=FID_SEED, param_seed=FID_SEED, device=dev)
    X_tr, X_te, Y_tr, Y_te, _, _ = train_test_split_np(X, Y, FID_TEST_SPLIT, FID_SEED)
    with contextlib.redirect_stdout(io.StringIO()):
        splits = split_data_numpy(X_tr, Y_tr, FID_AGENTS, "regional", 1.0, FID_SEED)
    return spec, X, Y, theta, X_tr, Y_tr, X_te, Y_te, splits


def check_fidelity_run(res, ref, iters: int, what: str):
    """Hold a fidelity training run to the fixture's first ``iters``
    iterations; returns (z dev, worst NLL rel dev, worst CV-NLPD dev / bar)."""
    check(res.iterations == iters, f"{what}: stopped after {res.iterations} != {iters}")
    z = np.array([h["consensus_params"] for h in res.cv_history])
    z_dev = float(np.abs(z - np.array(ref["z_trajectory"][:iters])).max())
    nll = np.array([h["agent_losses"] for h in res.nll_history])
    nll_ref = np.array(ref["agent_nll"][:iters])
    nll_dev = float((np.abs(nll - nll_ref) / np.abs(nll_ref)).max())
    cv = np.array([h["consensus_cv_score"] for h in res.cv_history])
    cv32 = np.array(ref["cv_nlpd"][:iters])
    cv_bar = np.maximum(NLPD_TOL, 2 * np.abs(cv32 - np.array(ref["cv_nlpd_f64_features"][:iters])))
    cv_ratio = float((np.abs(cv - cv32) / cv_bar).max())
    check(bool(np.all(np.isfinite(nll))) and bool(np.all(np.isfinite(cv))),
          f"{what}: non-finite NLL or CV score")
    check(z_dev <= Z_TOL, f"{what}: z trajectory deviates {z_dev} > {Z_TOL}")
    check(nll_dev <= NLL_RTOL, f"{what}: agent NLL deviates rel {nll_dev} > {NLL_RTOL}")
    check(cv_ratio <= 1.0, f"{what}: CV-NLPD {cv.tolist()} vs JAX f32 {cv32.tolist()} "
          f"beyond the bars {cv_bar.tolist()}")
    return z_dev, nll_dev, cv_ratio


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1

    from dqgp_tpu_torch import config
    from dqgp_tpu_torch.data import split_data_numpy
    from dqgp_tpu_torch.driver import TrainConfig, train
    from dqgp_tpu_torch.models.circuits import ENCODING_TYPES, build_circuit
    from dqgp_tpu_torch.models.gp.cv import cv_fold_scores_impl, kfold_pad_indices
    from dqgp_tpu_torch.models.gp.metrics import evaluate_predictions
    from dqgp_tpu_torch.models.gp.posterior import predict_quantum_gp
    from dqgp_tpu_torch.models.kernels import QuantumKernelSpec
    from dqgp_tpu_torch.models.kernels.quantum_kernel import (
        gram_from_features, kernel_features)
    from dqgp_tpu_torch.ops import cuda_circuit as K
    from dqgp_tpu_torch.ops.fusion import fuse_circuit, packed_inputs
    from dqgp_tpu_torch.parallel.consensus import make_admm_step, make_agent_batch

    dev = torch.device("cuda", 0)
    config.set_precision_policy()
    config.use_fusion = "auto"

    # 1. device --------------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)  # phase 1: the card's name and power limit, as nvidia-smi gives them

    # 2. build ---------------------------------------------------------------
    t0 = time.time()
    reports = build_kernels(K.SOURCES)
    for src in K.SOURCES:
        K._library(src)
    print(f"phase 2 build ({time.time() - t0:.2f} s): " + " | ".join(reports), flush=True)

    # 3. K1 vs plain on the card ----------------------------------------------
    main_circuit = build_circuit("chebyshev", NUM_QUBITS, NUM_FEATURES, NUM_LAYERS)
    k1_cases = [(build_circuit(enc, n, NUM_FEATURES, 2), B)
                for enc in ENCODING_TYPES for n in K1_QUBITS for B in K1_BATCHES]
    k1_cases += [(main_circuit, B) for B in (STEP_ROWS, N_SAMPLES, N_TEST)]
    gen = torch.Generator(device=dev).manual_seed(0)

    def rand_angles(circuit, B, dtype=torch.float32):
        return (torch.rand((B, circuit.num_gates), generator=gen, device=dev,
                           dtype=dtype) * 4.0 - 1.0) * np.pi

    worst = 0.0
    for circuit, B in k1_cases:
        n = circuit.num_qubits
        angles = rand_angles(circuit, B)
        got = K.pauli_features_from_angles(circuit, angles)
        want = K.pauli_features_reference(circuit, angles)
        torch.cuda.synchronize()
        check(got.shape == (B, 3 * n), f"K1 shape {tuple(got.shape)}")
        err = float((got - want).abs().max())
        check(np.isfinite(err) and err <= K1_TOL,
              f"K1 vs plain {circuit.name} {n}q B={B}: max abs diff {err}")
        worst = max(worst, err)
    print(f"phase 3 K1 vs plain: {len(k1_cases)} cases, max abs diff {worst:.3e} "
          f"(tol {K1_TOL})", flush=True)

    # 4. the main path ------------------------------------------------------------
    with open(FIXTURE) as f:
        ref = json.load(f)
    X, Y, X_test, Y_test = make_problem()
    check(problem_digest(X, Y, X_test, Y_test) == ref["problem"]["sha256"],
          "north-star data differ from the fixture's")
    spec = QuantumKernelSpec(circuit=main_circuit, kernel_type="projected",
                             outer_kernel="matern")
    splits = split_data_numpy(X, Y, N_AGENTS, "regional")
    check(N_AGENTS * (2 * spec.num_parameters + 1) * max(len(x) for x, _ in splits)
          == STEP_ROWS, "the step's K1 batch is not the one phase 3 checked")
    cfg = TrainConfig(max_iter=ITERS, verbose=False)

    K.reset_launch_counts()
    t0 = time.time()
    res = train(spec, splits, X, Y, cfg, device=dev)
    z_best = torch.as_tensor(res.z, device=dev)
    mean, var = predict_quantum_gp(
        spec, torch.as_tensor(X, device=dev), torch.as_tensor(Y, device=dev),
        torch.as_tensor(X_test, device=dev), z_best, noise_std=cfg.noise_std)
    metrics = evaluate_predictions(Y_test, mean, var)
    torch.cuda.synchronize()
    main_s = time.time() - t0
    counts = K.launch_counts()
    launches = counts["K1"]

    rescores = sum(h["solver"] == "float64-rescue" for h in res.cv_history)
    check(launches == 2 * ITERS + 2 + rescores,
          f"K1 launches {launches} != 2*{ITERS} + 2 + {rescores} re-scores")
    check(sum(counts.values()) == launches, f"other kernels ran on the K1 path: {counts}")
    nlls = [v for h in res.nll_history for v in h["agent_losses"]]
    cvs = [h["consensus_cv_score"] for h in res.cv_history]
    check(res.iterations == ref["iterations"] and res.converged_by == ref["converged_by"],
          f"stopped {res.converged_by}@{res.iterations}, reference "
          f"{ref['converged_by']}@{ref['iterations']}")
    check(all(np.isfinite(nlls)) and all(np.isfinite(cvs)), "non-finite NLL or CV score")
    check(mean.shape == (N_TEST,) and bool(torch.isfinite(mean).all())
          and bool(torch.isfinite(var).all()), "non-finite prediction")
    z_traj = np.array([h["consensus_params"] for h in res.cv_history])
    z_dev = float(np.abs(z_traj - np.array(ref["z_trajectory"])).max())
    cv_dev = float(np.abs(np.array(cvs) - np.array(ref["cv_nlpd"])).max())
    nlpd_dev = abs(metrics["nlpd"] - ref["test_metrics"]["nlpd"])
    print(f"phase 4 main path: {ITERS} ADMM iterations + predict in {main_s:.2f} s; "
          f"K1 launches {launches} (= 2*{ITERS} + 2 + {rescores} f64 CV re-scores); "
          f"z dev {z_dev:.1e} (tol {Z_TOL}), CV-NLPD dev {cv_dev:.2e}, test NLPD "
          f"{metrics['nlpd']:.4f} vs {ref['test_metrics']['nlpd']:.4f} "
          f"(tol {NLPD_TOL}), test R2 {metrics['r2']:.4f}", flush=True)
    check(z_dev <= Z_TOL, f"z trajectory deviates {z_dev} > {Z_TOL}")
    check(cv_dev <= NLPD_TOL, f"CV-NLPD deviates {cv_dev} > {NLPD_TOL}")
    check(nlpd_dev <= NLPD_TOL, f"test NLPD deviates {nlpd_dev} > {NLPD_TOL}")

    # 5. times (after warm-up; launches here are not the main path's) -------
    step = make_admm_step(spec, rho=cfg.rho, L=cfg.L, noise_std=cfg.noise_std)
    batch = make_agent_batch(splits, dev)
    Xt, Yt = torch.as_tensor(X, device=dev), torch.as_tensor(Y, device=dev)
    state = [torch.as_tensor(res.theta, device=dev), torch.as_tensor(res.psi, device=dev)]
    folds = kfold_pad_indices(N_SAMPLES, cfg.cv_folds, cfg.seed, dev)

    def iteration():
        out = step(state[0], state[1], batch)
        cv_fold_scores_impl(spec, Xt, Yt, out.z, *folds, noise_std=cfg.noise_std)
        state[0], state[1] = out.theta, out.psi

    iteration()
    iter_ms = _cuda_time_ms(iteration, 5)

    circuit = spec.circuit
    angles = rand_angles(circuit, STEP_ROWS)
    k1_ms, plain_ms = _alternate_ms(
        [lambda: K.pauli_features_from_angles(circuit, angles),
         lambda: K.pauli_features_reference(circuit, angles)], 20)

    z32 = torch.as_tensor(res.z, device=dev)

    def gram_1000():
        gram_from_features(spec, kernel_features(spec, Xt, z32))

    gram_1000()
    gram_ms = _cuda_time_ms(gram_1000, 20)
    print(f"phase 5 times [{smi}]: ADMM iteration (step + 5-fold CV) "
          f"{iter_ms:.3f} ms; K1 {k1_ms:.4f} ms vs plain {plain_ms:.4f} ms at "
          f"B={STEP_ROWS} G={circuit.num_gates} n={circuit.num_qubits} "
          f"({plain_ms / k1_ms:.1f}x); 1000x1000 projected Gram "
          f"{gram_ms:.4f} ms ({1e6 / (gram_ms * 1e-3):.3e} entries/s)", flush=True)

    # 6. K2, K1 float64 and K4 vs their plain versions on the card ------------
    fid_circuit = build_circuit("kyriienko", FID_QUBITS, 1, FID_LAYERS)
    n_train = FID_SAMPLES - int(np.ceil(FID_TEST_SPLIT * FID_SAMPLES))
    st_cases = [(build_circuit(enc, n, NUM_FEATURES, 2), B)
                for enc in ENCODING_TYPES for n in STATES_QUBITS for B in STATES_BATCHES]
    st_cases += [(fid_circuit, B) for B in (FID_STEP_ROWS, n_train, FID_SAMPLES - n_train)]
    err = dict.fromkeys(("K2", "K2_f64", "K1_f64", "K4", "K4_unfused"), 0.0)

    def hold(key, got, want, tol, what):
        torch.cuda.synchronize()
        check(got.shape == want.shape and got.dtype == want.dtype,
              f"{key} {what}: {tuple(got.shape)} {got.dtype} vs "
              f"{tuple(want.shape)} {want.dtype}")
        e = float((got - want).abs().max())
        check(np.isfinite(e) and e <= tol, f"{key} vs plain {what}: max abs diff {e} > {tol}")
        err[key] = max(err[key], e)

    for circuit, B in st_cases:
        what = f"{circuit.name} {circuit.num_qubits}q B={B}"
        a32, a64 = rand_angles(circuit, B), rand_angles(circuit, B, torch.float64)
        plain = K.states_reference(circuit, a32)
        hold("K2", K.states_from_angles(circuit, a32), plain, K2_TOL, what)
        hold("K4", K.states_from_angles_fused(circuit, a32),
             K.states_fused_reference(circuit, a32), K4_TOL, what)
        hold("K4_unfused", K.states_from_angles_fused(circuit, a32), plain, K4_TOL, what)
        del plain
        hold("K2_f64", K.states_from_angles(circuit, a64),
             K.states_reference(circuit, a64), F64_TOL, what)
        hold("K1_f64", K.pauli_features_from_angles(circuit, a64),
             K.pauli_features_reference(circuit, a64), F64_TOL, what)
    print(f"phase 6 states vs plain: {len(st_cases)} cases; max abs diff K2 f32 "
          f"{err['K2']:.3e} (tol {K2_TOL}), K2 f64 {err['K2_f64']:.3e} (tol {F64_TOL}), "
          f"K1 f64 {err['K1_f64']:.3e} (tol {F64_TOL}), K4 {err['K4']:.3e} vs plain "
          f"fused / {err['K4_unfused']:.3e} vs plain unfused (tol {K4_TOL})", flush=True)

    # 7. the fidelity path: dataset, split, 5 ADMM iterations, predict -------
    with open(FIDELITY_FIXTURE) as f:
        fref = json.load(f)
    fcfg = TrainConfig(max_iter=FID_ITERS, verbose=False, seed=FID_SEED)
    K.reset_launch_counts()
    t0 = time.time()
    fspec, FX, FY, theta_star, X_tr, Y_tr, X_te, Y_te, fsplits = fidelity_problem(dev)
    gen_s = time.time() - t0
    check(fspec.circuit.num_gates == 23 and fspec.num_parameters == 12,
          "config #5's circuit is not G=23, P=12")
    check(array_digest(FX) == fref["problem"]["x_sha256"], "dataset X differs from the fixture's")
    check(np.array_equal(theta_star, fref["problem"]["theta_star"]), "theta* differs")
    y_dev = float(np.abs(FY - np.array(fref["problem"]["Y"])).max())
    check(y_dev <= 1e-6, f"dataset Y deviates {y_dev} > 1e-6 from the JAX float64 dataset")
    check([len(x) for x, _ in fsplits] == fref["problem"]["shard_sizes"], "shard sizes differ")
    check(FID_AGENTS * (2 * fspec.num_parameters + 1) * max(len(x) for x, _ in fsplits)
          == FID_STEP_ROWS, "the step's K2 batch is not the one phase 6 checked")
    t1 = time.time()
    fres = train(fspec, fsplits, X_tr, Y_tr, fcfg, ground_truth_params=theta_star, device=dev)
    fmean, fvar = predict_quantum_gp(
        fspec, torch.as_tensor(X_tr, device=dev), torch.as_tensor(Y_tr, device=dev),
        torch.as_tensor(X_te, device=dev), torch.as_tensor(fres.z, device=dev),
        noise_std=fcfg.noise_std)
    fmetrics = evaluate_predictions(Y_te, fmean, fvar)
    torch.cuda.synchronize()
    fid_s = time.time() - t1
    fcounts = K.launch_counts()
    frescores = sum(h["solver"] == "float64-rescue" for h in fres.cv_history)
    check(fcounts["K2"] == 2 * FID_ITERS + 2 + frescores and fcounts["K2_f64"] == 1
          and fcounts["K1"] == fcounts["K1_f64"] == fcounts["K4"] == 0,
          f"fidelity path launches {fcounts}: want K2 = 2*{FID_ITERS} + 2 + "
          f"{frescores}, K2_f64 = 1 (the dataset Gram), no other kernel")
    check(fres.converged_by == fref["converged_by"], f"stopped by {fres.converged_by}")
    check(fmean.shape == (len(X_te),) and bool(torch.isfinite(fmean).all())
          and bool(torch.isfinite(fvar).all()), "non-finite fidelity prediction")
    fz_dev, fnll_dev, fcv_ratio = check_fidelity_run(fres, fref, FID_ITERS, "fidelity")
    tref = fref["test_metrics"]["nlpd"]
    t_bar = max(NLPD_TOL, 2 * abs(tref - fref["test_nlpd_f64_features"]))
    check(abs(fmetrics["nlpd"] - tref) <= t_bar,
          f"fidelity test NLPD {fmetrics['nlpd']} vs JAX f32 {tref} beyond {t_bar}")
    print(f"phase 7 fidelity path: dataset ({FID_SAMPLES} rows, f64 Gram on the card) "
          f"in {gen_s:.2f} s, Y dev {y_dev:.2e} (tol 1e-6); {FID_ITERS} ADMM iterations "
          f"+ predict in {fid_s:.2f} s; launches {fcounts} (K2 = 2*{FID_ITERS} + 2 + "
          f"{frescores} re-scores); z dev {fz_dev:.1e} (tol {Z_TOL}), agent NLL rel dev "
          f"{fnll_dev:.2e} (tol {NLL_RTOL}), worst CV-NLPD dev / bar {fcv_ratio:.3f}, "
          f"CV-NLPD {[round(h['consensus_cv_score'], 4) for h in fres.cv_history]} vs "
          f"JAX f32 {[round(v, 4) for v in fref['cv_nlpd']]}; test NLPD "
          f"{fmetrics['nlpd']:.4f} vs {tref:.4f} (bar {t_bar:.3f}), test R2 "
          f"{fmetrics['r2']:.4f}", flush=True)

    # 8. the fidelity path with fusion on: K4 in K2's place ------------------
    config.use_fusion = "on"
    try:
        K.reset_launch_counts()
        ures = train(fspec, fsplits, X_tr, Y_tr,
                     TrainConfig(max_iter=FID_FUSED_ITERS, verbose=False, seed=FID_SEED),
                     ground_truth_params=theta_star, device=dev)
        torch.cuda.synchronize()
        ucounts = K.launch_counts()
    finally:
        config.use_fusion = "auto"
    urescores = sum(h["solver"] == "float64-rescue" for h in ures.cv_history)
    check(ucounts["K4"] == 2 * FID_FUSED_ITERS + urescores
          and sum(ucounts.values()) == ucounts["K4"],
          f"fused path launches {ucounts}: want K4 = 2*{FID_FUSED_ITERS} + "
          f"{urescores} and no other kernel")
    uz_dev, unll_dev, ucv_ratio = check_fidelity_run(ures, fref, FID_FUSED_ITERS, "fused")
    program = fuse_circuit(fspec.circuit)
    print(f"phase 8 fused fidelity path: {FID_FUSED_ITERS} ADMM iterations, "
          f"{len(program.ops)} fused ops (R={program.n_rows}) for {fspec.circuit.num_gates} "
          f"gates; launches {ucounts}; z dev {uz_dev:.1e}, agent NLL rel dev "
          f"{unll_dev:.2e}, worst CV-NLPD dev / bar {ucv_ratio:.3f}", flush=True)

    # 9. times of the fidelity path ------------------------------------------
    fstep = make_admm_step(fspec, rho=fcfg.rho, L=fcfg.L, noise_std=fcfg.noise_std)
    fbatch = make_agent_batch(fsplits, dev)
    FXt, FYt = torch.as_tensor(X_tr, device=dev), torch.as_tensor(Y_tr, device=dev)
    fstate = [torch.as_tensor(fres.theta, device=dev), torch.as_tensor(fres.psi, device=dev)]
    ffolds = kfold_pad_indices(len(X_tr), fcfg.cv_folds, fcfg.seed, dev)

    def fid_iteration():
        out = fstep(fstate[0], fstate[1], fbatch)
        cv_fold_scores_impl(fspec, FXt, FYt, out.z, *ffolds, noise_std=fcfg.noise_std)

    fid_iteration()
    fid_iter_ms = _cuda_time_ms(fid_iteration, 5)

    a = rand_angles(fid_circuit, FID_STEP_ROWS)
    k2_ms, k2_plain_ms, k4_ms, k4_plain_ms = _alternate_ms(
        [lambda: K.states_from_angles(fid_circuit, a),
         lambda: K.states_reference(fid_circuit, a),
         lambda: K.states_from_angles_fused(fid_circuit, a),
         lambda: K.states_fused_reference(fid_circuit, a)], 20)
    c10 = build_circuit("kyriienko", 10, 1, FID_LAYERS)
    a10 = rand_angles(c10, FID_STEP_ROWS)
    k2_10_ms, k4_10_ms = _alternate_ms(
        [lambda: K.states_from_angles(c10, a10),
         lambda: K.states_from_angles_fused(c10, a10)], 10)
    # K4's time includes its packed input, built outside the kernel in torch;
    # the kernel alone runs on rows packed ahead
    p6 = packed_inputs(fuse_circuit(fid_circuit), a)
    p10 = packed_inputs(fuse_circuit(c10), a10)
    k4k_ms, k4k_10_ms = _alternate_ms(
        [lambda: K.states_from_packed(fid_circuit, p6),
         lambda: K.states_from_packed(c10, p10)], 10)
    a64 = rand_angles(fid_circuit, FID_SAMPLES, torch.float64)
    k2_64_ms, k2_64_plain_ms = _alternate_ms(
        [lambda: K.states_from_angles(fid_circuit, a64),
         lambda: K.states_reference(fid_circuit, a64)], 20)
    fz32 = torch.as_tensor(fres.z, device=dev)

    def fid_gram():
        gram_from_features(fspec, kernel_features(fspec, FXt, fz32))

    fid_gram()
    fgram_ms = _cuda_time_ms(fid_gram, 20)
    print(f"phase 9 times [{smi}]: fidelity ADMM iteration (step + 5-fold CV) "
          f"{fid_iter_ms:.3f} ms; at B={FID_STEP_ROWS} G=23 n=6: K2 {k2_ms:.4f} ms vs "
          f"plain {k2_plain_ms:.4f} ms ({k2_plain_ms / k2_ms:.1f}x), K4 {k4_ms:.4f} ms "
          f"vs plain fused {k4_plain_ms:.4f} ms ({k4_plain_ms / k4_ms:.1f}x), the K4 kernel "
          f"alone {k4k_ms:.4f} ms; K2 vs K4 at 10 qubits (kyriienko, G={c10.num_gates}): "
          f"{k2_10_ms:.4f} vs {k4_10_ms:.4f} ms (the K4 kernel alone {k4k_10_ms:.4f} ms); "
          f"K2 f64 {k2_64_ms:.4f} ms vs plain c128 "
          f"{k2_64_plain_ms:.4f} ms at B={FID_SAMPLES}; {len(X_tr)}x{len(X_tr)} "
          f"fidelity Gram {fgram_ms:.4f} ms "
          f"({len(X_tr) ** 2 / (fgram_ms * 1e-3):.3e} entries/s)", flush=True)

    print(json.dumps({"kernels": [
        {"name": "pauli_features (K1)", "route": "cuda",
         "source": "dqgp_tpu_torch/csrc/pauli_features.cu",
         "replaces": "dqgp_tpu/ops/pallas_circuit.py:392",
         "launches": launches, "max_abs_err": worst, "ms": k1_ms, "plain_ms": plain_ms,
         "max_abs_err_f64": err["K1_f64"]},
        {"name": "states (K2)", "route": "cuda",
         "source": "dqgp_tpu_torch/csrc/states.cu",
         "replaces": "dqgp_tpu/ops/pallas_circuit.py:238",
         "launches": fcounts["K2"], "max_abs_err": err["K2"], "ms": k2_ms,
         "plain_ms": k2_plain_ms, "launches_f64": fcounts["K2_f64"],
         "max_abs_err_f64": err["K2_f64"], "ms_f64": k2_64_ms,
         "plain_ms_f64": k2_64_plain_ms},
        {"name": "states_fused (K4)", "route": "cuda",
         "source": "dqgp_tpu_torch/csrc/states_fused.cu",
         "replaces": "dqgp_tpu/ops/pallas_circuit.py:278",
         "launches": ucounts["K4"], "max_abs_err": err["K4"], "ms": k4_ms,
         "plain_ms": k4_plain_ms},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
