"""Command-line entry point of the port: ``python -m dqgp_tpu_torch.cli``,
``python -m dqgp_tpu_torch`` or the ``dqgp-torch`` script.

Port of ``dqgp_tpu/cli.py``, flag for flag (the reference's ``main.py``
surface plus the JAX package's additions), with one flag more: ``--device``
(default ``cuda``). With no card and no ``--device cpu`` the run raises; it
never falls back to the CPU.

Pipeline (main.py:2045-3682): dataset (quantum synthetic, classical or
real-world) -> train/test split -> agent partitioning -> ADMM training with
per-iteration CV model selection -> the optional marginal-likelihood noise
fit -> prediction with the best-CV consensus (dense, or the CG posterior
above ``--predict-cg-threshold``) -> evaluation, the ground-truth comparison
for synthetic data -> plots and the metrics JSON.

Flags that reach what the port does not have fail before any work:
``--mesh-devices`` / ``--data-mesh-cols`` (meshes, ROADMAP Queue 1 item
11), ``--gp-dtype mixed`` / ``--cv-dtype mixed`` (the TPU's emulated-float64
solver), and ``--regularization`` on the CG route (the low-rank eigenvalue
clip, Queue 1 item 8). ``--profile-dir`` writes a ``torch.profiler`` trace
of each stage (loading, training, each prediction, ...), the program's
spans (``tracing``) on a row of their own above the operators and kernels
they ran.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from . import tracing


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Distributed Quantum Gaussian Process Regression with Riemannian "
                    "ADMM (the PyTorch/CUDA port)"
    )
    parser.add_argument("--n-agents", type=int, default=4)
    parser.add_argument("--num-qubits", type=int, default=4)
    parser.add_argument("--num-layers", type=int, default=2)
    parser.add_argument("--max-iter", type=int, default=100)
    parser.add_argument("--tolerance", type=float, default=1e-6)
    parser.add_argument("--rho", type=float, default=100.0)
    parser.add_argument("--L", type=float, default=100.0)
    parser.add_argument("--input-dim", type=int, default=1, choices=[1, 2, 3, 4, 5, 6])
    parser.add_argument("--n-dataset", type=int, default=100)
    parser.add_argument("--partition", choices=["regional", "random", "sequential"], default="regional")
    parser.add_argument("--data-percentage", type=float, default=1.0)
    parser.add_argument("--noise-std", type=float, default=0.1)
    parser.add_argument("--test-split", type=float, default=0.1)
    parser.add_argument("--num-workers", type=int, default=None,
                        help="accepted for reference compatibility; execution is on-device")
    parser.add_argument("--shift-value", type=float, default=float(np.pi / 8))

    # dataset selection
    parser.add_argument("--classical-dataset", action="store_true")
    parser.add_argument("--real-world-dataset", type=str, default=None,
                        choices=["sst", "sea_surface_temperature", "robot_push", "robot",
                                 "push", "srtm_elevation", "srtm", "elevation"])
    parser.add_argument("--srtm-region", type=str, default="maharashtra",
                        choices=["maharashtra", "great_lakes", "oregon_coast", "washington_coast"])
    parser.add_argument("--use-srtm-preprocessed", action="store_true", default=False)
    parser.add_argument("--dataset-max-samples", type=int, default=5000)
    parser.add_argument("--dataset-subsample", type=int, default=10)
    parser.add_argument("--dataset-normalize", action="store_true", default=False)
    parser.add_argument("--dataset-only", action="store_true")
    parser.add_argument("--save-dataset", action="store_true")
    parser.add_argument("--dataset-name", type=str, default="quantum_dataset")
    parser.add_argument("--data-range", nargs=2, type=float, default=[-2.0, 2.0])
    parser.add_argument("--encoding",
                        choices=["chebyshev", "yz_cx", "hubregtsen", "kyriienko",
                                 "multi_control", "layered", "random", "highdim"],
                        default="yz_cx")
    parser.add_argument("--kernel-type", choices=["fidelity", "projected"], default="fidelity")
    parser.add_argument("--measurement", type=str, default="XYZ")
    parser.add_argument("--outer-kernel", type=str, default="gaussian",
                        choices=["gaussian", "matern", "expsinesquared",
                                 "rationalquadratic", "dotproduct", "pairwisekernel"])
    parser.add_argument("--outer-kernel-gamma", type=float, default=1.0)
    parser.add_argument("--outer-kernel-length-scale", type=float, default=1.0)
    parser.add_argument("--outer-kernel-nu", type=float, default=1.5)
    parser.add_argument("--outer-kernel-alpha", type=float, default=1.0)
    parser.add_argument("--outer-kernel-sigma", type=float, default=1.0)
    parser.add_argument("--outer-kernel-periodicity", type=float, default=1.0)
    parser.add_argument("--regularization", type=str, default=None,
                        choices=["thresholding", "tikhonov", None])
    parser.add_argument("--no-plot", action="store_true")
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--data-seed", type=int, default=None)
    parser.add_argument("--kernel-params", type=float, nargs="+", default=None)

    # Riemannian optimization
    parser.add_argument("--riemannian-lr", type=float, default=0.015)
    parser.add_argument("--riemannian-method",
                        choices=["gradient_descent", "momentum", "conjugate_gradient"],
                        default="gradient_descent")
    parser.add_argument("--riemannian-beta", type=float, default=0.9)
    parser.add_argument("--gradient-clip-norm", type=float, default=1.0)
    parser.add_argument("--max-step-size", type=float, default=0.1)

    # cross-validation
    parser.add_argument("--cv-folds", type=int, default=5)
    parser.add_argument("--cv-patience", type=int, default=50)

    # --- additions over the reference (the JAX package's) ------------------
    parser.add_argument("--apply-outer-kernel-params", action="store_true",
                        help="actually honor --outer-kernel-* values (the reference "
                             "assembles but drops them, SURVEY.md §2.1)")
    parser.add_argument("--grad-method",
                        choices=["central", "streamed", "autodiff"],
                        default="central",
                        help="kernel-gradient method: 'central' reproduces the "
                             "reference's h=pi/8 finite difference; 'streamed' "
                             "is the same difference with O(N^2) live memory "
                             "(large shards); 'autodiff' differentiates "
                             "through the simulator (exact)")
    parser.add_argument("--no-parity-round", action="store_true",
                        help="disable the reference's 4-decimal per-iteration quantization")
    parser.add_argument("--no-cv", action="store_true",
                        help="skip per-iteration k-fold CV model selection")
    parser.add_argument("--no-cond", action="store_true",
                        help="skip per-iteration condition numbers")
    parser.add_argument("--cond-mode", type=str, default="auto",
                        choices=["auto", "device", "host"],
                        help="where condition numbers compute: 'device' in the "
                             "step, from its float32-built Gram; 'host' after "
                             "training, exact float64 eigenvalues of each agent's "
                             "float64 Gram on the training device. "
                             "auto = device on the CPU, host on the card")
    parser.add_argument("--srtm-time-seed", action="store_true",
                        help="reproduce the reference's time-based SRTM seeding "
                             "(main.py:2136-2138); default uses --seed for reproducibility")
    parser.add_argument("--generating-noise-std", type=float, default=None,
                        help="sample the synthetic quantum dataset with THIS "
                             "noise while the GP still uses --noise-std — a "
                             "deliberate-misspecification experiment knob "
                             "(default: --noise-std, the reference's "
                             "single-constant behavior)")
    parser.add_argument("--fit-noise", action="store_true",
                        help="after training, refit --noise-std by maximizing "
                             "the training marginal likelihood at the selected "
                             "hyperparameters (models/gp/noise.py) and predict "
                             "with the fitted value; the reference keeps the "
                             "CLI constant (misspecified on real data — see "
                             "docs/PERFORMANCE.md SRTM calibration)")
    parser.add_argument("--fit-noise-max-samples", type=int, default=2048,
                        help="cap on the dense-Gram eigendecomposition the "
                             "--fit-noise MLL fit runs on; larger training "
                             "sets fit on a seeded subsample of this size "
                             "(estimator stderr ~sigma/sqrt(2n))")
    parser.add_argument("--predictive-noise", action="store_true",
                        help="evaluate the OBSERVED-Y predictive variance "
                             "(latent variance + noise_std^2); the reference "
                             "scores latent variance only (main.py:1429-1466), "
                             "which under-covers exactly by the noise term")
    parser.add_argument("--checkpoint-dir", type=str, default=None)
    parser.add_argument("--checkpoint-every", type=int, default=10)
    parser.add_argument("--resume-from", type=str, default=None)
    parser.add_argument("--output-dir", type=str, default="results")
    parser.add_argument("--metrics-json", type=str, default=None,
                        help="write structured run metrics to this JSON file")
    parser.add_argument("--mesh-devices", type=int, default=None,
                        help="meshes are not ported: only the default (one device)")
    parser.add_argument("--cv-max-samples", type=int, default=None,
                        help="subsample the training set for per-iteration CV "
                             "beyond this size (the dense fold Grams are "
                             "O(n^2); scale-out runs cap the CV set)")
    parser.add_argument("--chain-iters", type=int, default=1,
                        help=">1: run this many ADMM iterations per dispatch, "
                             "a CUDA-graph replay on the card (identical "
                             "trajectory and stopping iteration)")
    parser.add_argument("--predict-cg-threshold", type=int, default=8192,
                        help="above this training size the final prediction "
                             "uses the matrix-free CG posterior instead of "
                             "the dense Cholesky (train-set evaluation then "
                             "runs on a subsample of this size)")
    parser.add_argument("--data-mesh-cols", type=int, default=None,
                        help="meshes are not ported: only the default")
    parser.add_argument("--cv-dtype",
                        choices=["auto", "float64", "mixed", "float32"],
                        default="auto",
                        help="dtype for the per-iteration CV folds (auto = "
                             "float64; 'mixed' answers the TPU's emulated "
                             "float64 and is not ported)")
    parser.add_argument("--gp-dtype",
                        choices=["auto", "float64", "mixed", "float32"],
                        default="auto",
                        help="dtype for the per-agent NLL/gradient linalg "
                             "(auto = float64; 'mixed' is not ported)")
    parser.add_argument("--profile-dir", type=str, default=None,
                        help="write a torch.profiler trace of each stage into "
                             "this directory (load_trace.json, train_trace.json, "
                             "predict_test_trace.json, ...; Chrome trace format, "
                             "the program's spans on a row of their own)")
    parser.add_argument("--verbose-agents", action="store_true",
                        help="reference-style per-agent NLL component and "
                             "condition-number report every iteration")
    parser.add_argument("--quiet", action="store_true")
    # --- the port's own ------------------------------------------------------
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to run on (default: cuda; there is no "
                             "fallback to the CPU, pass --device cpu for that)")
    return parser


def assemble_outer_kernel_params(args) -> dict:
    """main.py:2052-2077."""
    ok = args.outer_kernel
    if ok == "gaussian":
        return {"gamma": args.outer_kernel_gamma}
    if ok == "matern":
        return {"length_scale": args.outer_kernel_length_scale, "nu": args.outer_kernel_nu}
    if ok == "expsinesquared":
        return {"length_scale": args.outer_kernel_length_scale,
                "periodicity": args.outer_kernel_periodicity}
    if ok == "rationalquadratic":
        return {"length_scale": args.outer_kernel_length_scale,
                "alpha": args.outer_kernel_alpha}
    if ok == "dotproduct":
        return {"sigma_0": args.outer_kernel_sigma}
    return {}


def _json_sanitize(obj):
    """Strict-RFC JSON: non-finite floats (inf CV penalties etc.) -> None."""
    import math

    if isinstance(obj, dict):
        return {k: _json_sanitize(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_json_sanitize(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return _json_sanitize(obj.tolist())
    if isinstance(obj, (float, np.floating)):
        return float(obj) if math.isfinite(obj) else None
    if isinstance(obj, (np.integer,)):
        return int(obj)
    return obj


class StageClock:
    """Wall seconds of a run's stages, each read after the device has
    finished the stage's work: the seconds of a ``cli.<stage>`` span.

    With ``profile_dir``, each stage runs under ``torch.profiler``; its
    trace, with the spans the stage recorded on a row of their own, goes to
    ``<profile_dir>/<stage>_trace.json`` (``<stage>_<n>_trace.json`` for
    the stage's n-th run from the second on)."""

    def __init__(self, device: torch.device, profile_dir: Optional[str] = None, log=print):
        self.device = device
        self.profile_dir = profile_dir
        self.log = log
        self.seconds: Dict[str, float] = {}
        self.runs: Dict[str, int] = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        prof = None
        with contextlib.ExitStack() as stack:
            if self.profile_dir:
                activities = [torch.profiler.ProfilerActivity.CPU]
                if self.device.type == "cuda":
                    activities.append(torch.profiler.ProfilerActivity.CUDA)
                tracing.clear()  # the trace gets this stage's spans alone
                prof = stack.enter_context(torch.profiler.profile(activities=activities))
            with tracing.span(f"cli.{name}") as span:
                yield
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
        self.seconds[name] = self.seconds.get(name, 0.0) + span.elapsed
        n = self.runs[name] = self.runs.get(name, 0) + 1
        if prof is not None:
            os.makedirs(self.profile_dir, exist_ok=True)
            trace = os.path.join(self.profile_dir,
                                 f"{name}_trace.json" if n == 1 else f"{name}_{n}_trace.json")
            prof.export_chrome_trace(trace)
            add_spans_to_trace(trace, tracing.spans())
            self.log(f"Profiler trace written to {trace}")


def add_spans_to_trace(path: str, spans) -> None:
    """Append ``spans`` (``tracing.Span``) to the Chrome trace at ``path`` as
    complete events on a row of their own, on the trace's timeline."""
    with open(path) as f:
        trace = json.load(f)
    # Kineto writes "ts" in us from "baseTimeNanoseconds" (from the Unix
    # epoch where it has no such key); a span's times are Unix-epoch ns
    base = trace.get("baseTimeNanoseconds", 0)
    pid, tid = os.getpid(), 0  # no thread of the process has id 0
    events = [{"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
               "args": {"name": "program spans"}}]
    events += [{"ph": "X", "name": s.name, "cat": "span", "pid": pid, "tid": tid,
                "ts": (s.start_ns - base) / 1e3, "dur": (s.end_ns - s.start_ns) / 1e3}
               for s in spans if s.end_ns is not None]
    trace["traceEvents"].extend(events)
    with open(path, "w") as f:
        json.dump(trace, f)


def _host(x) -> np.ndarray:
    if torch.is_tensor(x):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def run(argv=None) -> Tuple[Optional[dict], Dict[str, float]]:
    """``main`` with the wall seconds of each stage beside its summary:
    load, split, train (the ADMM loop), backfill (the host-mode condition
    numbers after it), noise_fit, predict_test, predict_train, for
    synthetic data predict_ground_truth, and report (the post-training
    report and the metrics JSON)."""
    from . import config
    from . import manifold as M
    from .data import (
        generate_data_numpy,
        generate_quantum_gp_data,
        load_real_world_dataset,
        save_quantum_dataset,
        split_data_numpy,
        train_test_split_np,
    )
    from .driver import TrainConfig, check_config, train
    from .models.circuits import build_circuit
    from .models.gp import evaluate_predictions, predict_quantum_gp
    from .models.kernels import QuantumKernelSpec
    from .utils import plotting

    args = build_parser().parse_args(argv)
    if not (0.0 < args.data_percentage <= 1.0):
        raise ValueError(f"data_percentage must be between 0.0 and 1.0, got {args.data_percentage}")
    if not (0.0 < args.test_split < 1.0):
        # 1.0 would divide by zero sizing the classical dataset; 0.0 leaves
        # no test rows
        raise ValueError(f"test_split must be in (0, 1), got {args.test_split}")
    dev = config.resolve_device(args.device)
    cfg = TrainConfig(
        rho=args.rho, L=args.L, noise_std=args.noise_std,
        max_iter=args.max_iter, tolerance=args.tolerance,
        shift_value=args.shift_value, cv_folds=args.cv_folds,
        cv_patience=args.cv_patience, seed=args.seed,
        parity_round=not args.no_parity_round,
        compute_cond=not args.no_cond,
        cond_mode=args.cond_mode,
        grad_method=args.grad_method,
        gp_dtype=args.gp_dtype,
        cv_dtype=args.cv_dtype,
        run_cv=not args.no_cv,
        n_mesh_devices=args.mesh_devices,
        chain_iters=args.chain_iters,
        data_mesh_cols=args.data_mesh_cols,
        cv_max_samples=args.cv_max_samples,
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every,
        verbose=not args.quiet,
        verbose_agents=args.verbose_agents,
    )
    check_config(cfg)  # meshes and "mixed" dtypes raise before any work
    if not args.no_plot:
        plotting.pyplot()  # no matplotlib: fail now, naming --no-plot
    log = (lambda *a, **k: None) if args.quiet else print
    stage = StageClock(dev, args.profile_dir, log)

    np.random.seed(args.seed)
    outer_kernel_params = assemble_outer_kernel_params(args)

    # --- dataset ------------------------------------------------------------
    dataset_name = None
    srtm_data_seed = args.seed
    ground_truth_params = None
    input_dim = args.input_dim

    # measurement: single-qubit chars ("XYZ") or comma-separated multi-qubit
    # Pauli strings ("XXII,ZZII") — squlearn's list form (main.py:1994-1995)
    measurement = (tuple(args.measurement.split(","))
                   if "," in args.measurement else args.measurement)

    def make_spec(num_features: int) -> QuantumKernelSpec:
        circuit = build_circuit(args.encoding, args.num_qubits, num_features, args.num_layers)
        params = (tuple(sorted(outer_kernel_params.items()))
                  if args.apply_outer_kernel_params else ())
        return QuantumKernelSpec(
            circuit=circuit,
            kernel_type=args.kernel_type,
            measurement=measurement,
            outer_kernel=args.outer_kernel,
            outer_kernel_params=params,
            regularization=args.regularization,
        )

    with stage("load"):
        if args.real_world_dataset:
            log("=== Real-World Dataset Mode ===")
            key = args.real_world_dataset.lower()
            if key in ("srtm", "elevation", "srtm_elevation"):
                dataset_name = "srtm_elevation"
                if args.srtm_time_seed:
                    srtm_data_seed = int(time.time() * 1000) % 2**32
            elif key in ("sst", "sea_surface_temperature"):
                dataset_name = "sst"
            else:
                dataset_name = "robot_push"
            kwargs = dict(
                normalize=args.dataset_normalize,
                max_samples=args.dataset_max_samples,
                random_state=srtm_data_seed,
                save_plot=not args.no_plot,
            )
            if dataset_name == "sst":
                kwargs["subsample_factor"] = args.dataset_subsample
            elif dataset_name == "srtm_elevation":
                kwargs["region"] = args.srtm_region
                kwargs["subsample_factor"] = args.dataset_subsample
                kwargs["use_preprocessed"] = args.use_srtm_preprocessed
            X_full, Y_full = load_real_world_dataset(dataset_name, **kwargs)
            if not args.no_plot:
                # SRTM dataset figures go to srtm_plots/ as in the reference
                # (real_world_datasets.py:837)
                is_srtm = dataset_name == "srtm_elevation"
                plotting.plot_real_world_dataset(
                    X_full, Y_full, dataset_name,
                    region=(args.srtm_region if is_srtm else None),
                    save_plot=True,
                    output_dir=("srtm_plots" if is_srtm else args.output_dir),
                )
            input_dim = X_full.shape[1]
            spec = make_spec(input_dim)
        elif args.classical_dataset:
            log("=== Classical Dataset Training Mode ===")
            dataset_name = "classical"
            total = int(args.n_dataset / (1 - args.test_split))
            X_full, Y_full = generate_data_numpy(total, input_dim, args.noise_std, args.data_seed)
            spec = make_spec(input_dim)
        else:
            log("=== Quantum Dataset Generation Mode ===")
            dataset_name = "quantum"
            # recommended sample sizes per dimension (main.py:2216-2226)
            recommended = {1: 1000, 2: 32400, 3: 16900, 4: 32400, 5: 16900, 6: 32400}
            if args.n_dataset != recommended.get(input_dim, args.n_dataset):
                log(f"Note: Recommended sample size for {input_dim}D: "
                    f"{recommended.get(input_dim)}")
            spec = make_spec(input_dim)
            t0 = time.time()
            gen_noise = (args.generating_noise_std
                         if args.generating_noise_std is not None
                         else args.noise_std)
            X_full, Y_full, ground_truth_params = generate_quantum_gp_data(
                args.n_dataset, input_dim, spec,
                data_range=tuple(args.data_range), noise_std=gen_noise,
                kernel_params=(np.array(args.kernel_params) if args.kernel_params else None),
                data_seed=args.data_seed, param_seed=args.seed, verbose=not args.quiet,
                device=dev,
            )
            log(f"Quantum dataset generation time: {time.time() - t0:.4f}s")

    if args.save_dataset:
        fn = save_quantum_dataset(X_full, Y_full, args.dataset_name)
        log(f"Dataset saved to: {fn}")

    log(f"Dataset: {X_full.shape[0]} samples, {X_full.shape[1]}D input")
    if args.dataset_only:
        if not args.no_plot:
            plotting.plot_dataset(X_full, Y_full, save_plot=True, output_dir=args.output_dir)
        log("Stopping after dataset loading (--dataset-only flag)")
        return None, stage.seconds

    # --- split + partition ----------------------------------------------------
    with stage("split"):
        split_seed = srtm_data_seed if dataset_name == "srtm_elevation" else args.seed
        X_train, X_test, Y_train, Y_test, train_idx, test_idx = train_test_split_np(
            X_full, Y_full, args.test_split, split_seed)
        log(f"Train: {X_train.shape}, Test: {X_test.shape}")
        splits = split_data_numpy(X_train, Y_train, args.n_agents, args.partition,
                                  args.data_percentage, args.seed)
    for i, (Xa, _) in enumerate(splits):
        log(f"  Agent {i+1}: {Xa.shape[0]} samples")

    if not args.no_plot:
        plotting.plot_dataset(X_full, Y_full, save_plot=True, output_dir=args.output_dir,
                              train_indices=train_idx, test_indices=test_idx)
        plotting.plot_agent_data_distribution(splits, save_plot=True, output_dir=args.output_dir)

    log(f"Encoding circuit parameters: {spec.num_parameters}")

    # --- train ---------------------------------------------------------------
    with stage("train"):
        res = train(spec, splits, X_train, Y_train, cfg,
                    ground_truth_params=ground_truth_params,
                    resume_from=args.resume_from, device=dev)
    stage.seconds["backfill"] = res.cond_backfill_time or 0.0
    stage.seconds["train"] -= stage.seconds["backfill"]

    hyperparams = res.z_best_cv if res.z_best_cv is not None else res.z
    # post-training narrative (main.py:2786-3094)
    if not args.quiet:
        from .utils.analysis import post_training_report

        with stage("report"):
            post_training_report(res, log=log, ground_truth_params=ground_truth_params)

    # --- final prediction + evaluation (main.py:3104-3682) --------------------
    large_n = len(X_train) > max(args.predict_cg_threshold, 1)
    if large_n and spec.regularization is not None:
        # the matrix-free posterior applies square-Gram regularization via
        # the low-rank eigenvalue clip (parallel/blocked.py:
        # make_lowrank_regularizer), exact when the negative spectrum fits
        # the clip rank
        log("regularization set: the CG posterior applies it via the "
            "low-rank eigenvalue clip")

    _cg_predictors = {}
    # predict/eval noise: --fit-noise below may replace the CLI constant
    # with the marginal-likelihood optimum at the selected hyperparameters
    eval_noise = {"std": args.noise_std}
    X_train_t = torch.as_tensor(X_train, device=dev)
    Y_train_t = torch.as_tensor(Y_train, device=dev)

    def _predict(X_eval, params):
        params64 = torch.as_tensor(np.asarray(params, np.float64), device=dev)
        if large_n:
            # dense Gram no longer fits — matrix-free CG posterior; one
            # predictor per parameter vector (training features, the
            # preconditioner and the alpha solve are computed once)
            from .parallel.blocked import make_cg_predictor

            key = np.asarray(params, np.float64).tobytes()
            if key not in _cg_predictors:
                _cg_predictors[key] = make_cg_predictor(
                    spec, X_train_t, Y_train_t, params64, eval_noise["std"], device=dev)
            return _cg_predictors[key](X_eval)
        return predict_quantum_gp(
            spec, X_train_t, Y_train_t, torch.as_tensor(X_eval, device=dev), params64,
            noise_std=eval_noise["std"])

    def _eval_var(var):
        """Variance handed to metrics/plots: latent (reference semantics) or
        observed-Y (+noise^2) under --predictive-noise."""
        var = _host(var)
        return var + eval_noise["std"] ** 2 if args.predictive_noise else var

    noise_fit_info = None
    if args.fit_noise:
        from .models.gp import fit_noise_std

        with stage("noise_fit"):
            fit_n = min(len(X_train), max(args.fit_noise_max_samples, 8))
            if fit_n < len(X_train):
                # the exact fit needs a dense Gram + eigendecomposition; past
                # the cap, fit on a seeded subsample (the MLL noise
                # estimator's stderr is ~sigma/sqrt(2n))
                sel = np.random.RandomState(args.seed).choice(
                    len(X_train), fit_n, replace=False)
                X_fit, Y_fit = X_train[sel], Y_train[sel]
                log(f"--fit-noise: n_train={len(X_train)} > "
                    f"--fit-noise-max-samples={args.fit_noise_max_samples}; "
                    f"fitting on a seeded {fit_n}-sample subsample")
            else:
                X_fit, Y_fit = X_train, Y_train
            fit = fit_noise_std(
                spec, X_fit, Y_fit, np.asarray(hyperparams, np.float64),
                current_noise_std=args.noise_std, device=dev)
        eval_noise["std"] = fit.noise_std
        noise_fit_info = {
            "fitted_noise_std": fit.noise_std,
            "input_noise_std": args.noise_std,
            "train_nmll_fitted": fit.nmll,
            "train_nmll_input": fit.nmll_at_input,
            "fit_samples": int(fit_n),
        }
        log(f"--fit-noise: noise_std {args.noise_std} -> "
            f"{fit.noise_std:.4f} (train NMLL "
            f"{fit.nmll_at_input:.1f} -> {fit.nmll:.1f}, n={fit_n})")

    if large_n:
        log(f"n_train={len(X_train)} > --predict-cg-threshold="
            f"{args.predict_cg_threshold}: matrix-free CG posterior")
    with stage("predict_test"):
        mean, var = _predict(X_test, hyperparams)
        mean, var = _host(mean), _eval_var(var)
    test_metrics = evaluate_predictions(Y_test, mean, var, "Test", verbose=not args.quiet)
    # overfitting check (main.py:3162-3182); at scale, on a seeded subsample
    if large_n:
        sub_n = min(len(X_train), max(args.predict_cg_threshold, 1024))
        tr_sel = np.random.RandomState(args.seed).choice(
            len(X_train), sub_n, replace=False)
        X_tr_eval, Y_tr_eval = X_train[tr_sel], Y_train[tr_sel]
        train_label = f"Train ({sub_n}-sample subsample)"
    else:
        X_tr_eval, Y_tr_eval = X_train, Y_train
        train_label = "Train"
    with stage("predict_train"):
        mean_tr, var_tr = _predict(X_tr_eval, hyperparams)
        mean_tr, var_tr = _host(mean_tr), _eval_var(var_tr)
    train_metrics = evaluate_predictions(Y_tr_eval, mean_tr, var_tr, train_label,
                                         verbose=not args.quiet)

    gt_metrics = None
    gt_comparison = None
    nll_corr = None
    if ground_truth_params is not None:
        if args.encoding == "random":
            # docs/PARITY.md grades `random` as an irreducible non-match:
            # its seeded gate draw is builder-specific. Within this framework
            # the comparison is self-consistent; cross-implementation GT
            # claims are off the table.
            print("note: encoding 'random' uses a builder-specific seeded "
                  "gate draw — ground-truth comparisons below are "
                  "self-consistent but not squlearn-comparable "
                  "(docs/PARITY.md, 'random' row)")
        with stage("predict_ground_truth"):
            gt_mean, gt_var = _predict(X_test, ground_truth_params)
            gt_mean, gt_var = _host(gt_mean), _eval_var(gt_var)
        gt_metrics = evaluate_predictions(Y_test, gt_mean, gt_var,
                                          "Ground-truth-params Test", verbose=False)
        gt_err = M.np_distance(np.asarray(hyperparams), ground_truth_params)
        log("\n=== Ground-truth comparison (analysis only) ===")
        log(f"Riemannian ||z - theta*||: {gt_err:.6f} (best during run: {res.error_best:.6f})")
        from .utils.analysis import compare_gt_vs_trained, nll_error_correlation

        gt_comparison = compare_gt_vs_trained(test_metrics, gt_metrics)
        for k, row in gt_comparison["metrics"].items():
            log(f"  {k}: trained={row['trained']:.6f}  ground-truth={row['ground_truth']:.6f}"
                f"  [{row['significance']}{', trained better' if row['trained_better'] else ''}]")
        log(f"  verdict: {gt_comparison['verdict']}")
        nll_corr = nll_error_correlation(res.nll_history, res.error_history)
        if nll_corr.get("available"):
            log(f"  NLL-vs-param-error correlation: total={nll_corr['total_nll_vs_error']:.3f}, "
                f"components={ {k: round(v, 3) for k, v in nll_corr['components'].items()} }, "
                f"best predictor: {nll_corr['best_predictor']}")

    if not args.no_plot:
        plot_config = {"encoding": args.encoding, "kernel": args.kernel_type,
                       "qubits": args.num_qubits, "layers": args.num_layers}
        plotting.plot_predictions(
            X_test, Y_test, mean, var, X_train, Y_train,
            save_plot=True, output_dir=args.output_dir,
            config=plot_config,
            nlpd_info={"nlpd": test_metrics.get("nlpd", float("nan"))},
        )
        if ground_truth_params is not None:
            # GT-vs-trained prediction comparison (main.py:3194-3501): the
            # same plot rendered with the generating parameters.
            plotting.plot_predictions(
                X_test, Y_test, gt_mean, gt_var, X_train, Y_train,
                title="Quantum GP Predictions (ground-truth parameters)",
                save_plot=True, output_dir=args.output_dir,
                config=plot_config,
                nlpd_info={"nlpd": gt_metrics.get("nlpd", float("nan"))},
                filename="predictions_ground_truth.png",
            )
        plotting.plot_convergence(res.nll_history, res.cv_history,
                                  res.error_history or None,
                                  save_plot=True, output_dir=args.output_dir)

    summary = {
        "config": vars(args),
        "iterations": res.iterations,
        "converged_by": res.converged_by,
        "total_time_s": res.total_time,
        "cv_best_nlpd": res.cv_best,
        "final_z": np.asarray(res.z).tolist(),
        "best_cv_z": (np.asarray(res.z_best_cv).tolist() if res.z_best_cv is not None else None),
        "test_metrics": {k: v for k, v in test_metrics.items() if isinstance(v, (int, float))},
        "train_metrics": {k: v for k, v in train_metrics.items() if isinstance(v, (int, float))},
        "gt_metrics": ({k: v for k, v in gt_metrics.items() if isinstance(v, (int, float))}
                       if gt_metrics else None),
        "gt_error_best": res.error_best if ground_truth_params is not None else None,
        "gt_comparison": gt_comparison,
        "noise_fit": noise_fit_info,
        "eval_noise_std": eval_noise["std"],
        "nll_error_correlation": nll_corr,
        "nll_history": res.nll_history,
        "cv_history": [
            {k: (v.tolist() if isinstance(v, np.ndarray) else v) for k, v in h.items()}
            for h in res.cv_history
        ],
    }
    if args.metrics_json:
        with stage("report"):
            os.makedirs(os.path.dirname(args.metrics_json) or ".", exist_ok=True)
            with open(args.metrics_json, "w") as f:
                json.dump(_json_sanitize(summary), f, indent=2, default=float)
        log(f"Metrics written to {args.metrics_json}")
    return summary, stage.seconds


def main(argv=None):
    """Run the CLI on ``argv`` (default: ``sys.argv[1:]``); returns the
    run's summary (None after ``--dataset-only``), as ``dqgp_tpu.cli.main``
    does."""
    return run(argv)[0]


if __name__ == "__main__":
    main()
