#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``dqgp_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, one line each; any failure raises and exits non-zero:

1. device  — the card's name and power limit (nvidia-smi);
2. build   — nvcc builds the Pauli-feature kernel (K1) for sm_90a;
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
             1000x1000 Gram.

The last two lines are a JSON record of the kernels and
``{"ok": true, "device": {...}}``. The script imports nothing of JAX.
"""

import hashlib
import json
import os
import subprocess
import sys
import time

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
    from dqgp_tpu_torch.ops import _build
    from dqgp_tpu_torch.ops import cuda_circuit as K1
    from dqgp_tpu_torch.parallel.consensus import make_admm_step, make_agent_batch

    dev = torch.device("cuda", 0)
    config.set_precision_policy()

    # 1. device --------------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)  # phase 1: the card's name and power limit, as nvidia-smi gives them

    # 2. build ---------------------------------------------------------------
    t0 = time.time()
    lib_path, log = _build.build(K1.SOURCE)
    K1._library()
    regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
    print(f"phase 2 build: {K1.SOURCE} -> {os.path.basename(lib_path)} in "
          f"{time.time() - t0:.2f} s ({regs[0] if regs else 'reused'})", flush=True)

    # 3. K1 vs plain on the card ----------------------------------------------
    main_circuit = build_circuit("chebyshev", NUM_QUBITS, NUM_FEATURES, NUM_LAYERS)
    k1_cases = [(build_circuit(enc, n, NUM_FEATURES, 2), B)
                for enc in ENCODING_TYPES for n in K1_QUBITS for B in K1_BATCHES]
    k1_cases += [(main_circuit, B) for B in (STEP_ROWS, N_SAMPLES, N_TEST)]
    gen = torch.Generator(device=dev).manual_seed(0)
    worst = 0.0
    for circuit, B in k1_cases:
        n = circuit.num_qubits
        angles = (torch.rand((B, circuit.num_gates), generator=gen,
                             device=dev) * 4.0 - 1.0) * np.pi
        got = K1.pauli_features_from_angles(circuit, angles)
        want = K1.pauli_features_reference(circuit, angles)
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

    K1.pauli_features_from_angles.launches = 0
    t0 = time.time()
    res = train(spec, splits, X, Y, cfg, device=dev)
    z_best = torch.as_tensor(res.z, device=dev)
    mean, var = predict_quantum_gp(
        spec, torch.as_tensor(X, device=dev), torch.as_tensor(Y, device=dev),
        torch.as_tensor(X_test, device=dev), z_best, noise_std=cfg.noise_std)
    metrics = evaluate_predictions(Y_test, mean, var)
    torch.cuda.synchronize()
    main_s = time.time() - t0
    launches = K1.pauli_features_from_angles.launches

    rescores = sum(h["solver"] == "float64-rescue" for h in res.cv_history)
    check(launches == 2 * ITERS + 2 + rescores,
          f"K1 launches {launches} != 2*{ITERS} + 2 + {rescores} re-scores")
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
    angles = (torch.rand((STEP_ROWS, circuit.num_gates), generator=gen, device=dev)
              * 4.0 - 1.0) * np.pi
    kern = lambda: K1.pauli_features_from_angles(circuit, angles)
    plain = lambda: K1.pauli_features_reference(circuit, angles)
    kern(), plain()
    p1, k1, k2, p2 = (_cuda_time_ms(f, 20) for f in (plain, kern, kern, plain))
    k1_ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2

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

    print(json.dumps({"kernels": [{
        "name": "pauli_features (K1)",
        "route": "cuda",
        "source": "dqgp_tpu_torch/csrc/pauli_features.cu",
        "replaces": "dqgp_tpu/ops/pallas_circuit.py:392",
        "launches": launches,
        "max_abs_err": worst,
        "ms": k1_ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
