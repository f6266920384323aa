#!/usr/bin/env python
"""Where the time of one ADMM iteration of the PyTorch port goes, on a GPU.

    python scripts/profile_torch_port.py                # every cell
    python scripts/profile_torch_port.py --cell fidelity --iters 5
    python scripts/profile_torch_port.py --cell fidelity --fusion on
    python scripts/profile_torch_port.py --cell northstar --chain 5
    python scripts/profile_torch_port.py --cond device   # cond in the step
    python scripts/profile_torch_port.py --grad autodiff

For each cell — ``northstar`` (chip_smoke.py phase 4's problem),
``fidelity`` (phase 7's, BASELINE config #5) and ``config7`` (phase 11b's,
BASELINE config #7 at full size: 64 agents, 49,999 rows, streamed
gradients, CV on the 512-row subsample, no condition numbers) — it warms up
one iteration (the consensus step plus 5-fold CV, from the seeded initial
state), then runs ``--iters`` more (default 5, 1 for config7) under
``torch.profiler`` and prints per iteration: the
host wall time, the device time summed over kernels, the device's idle
share (1 - device / wall), the kernel count, and the device time by kernel
group with its share of the device time. ``--fusion`` sets the fusion
switch (``config.use_fusion``; "on" puts the fused states kernel K4 in K2's
place in the fidelity cell). ``--cond`` "host" (the default) runs the step
as ``driver.train`` runs it on the card, without condition numbers (they
are backfilled after training); "device" puts them in the step.
``--grad`` replaces the cell's gradient (central for the north star and
config #5, streamed for config #7) with "central", "streamed" or
"autodiff" (the adjoint kernel is a group of its own).
``--chain K`` profiles the driver's chained dispatch instead: the step and
CV pass of K iterations captured in one CUDA graph after a warm-up
iteration, ``--iters`` replays profiled, the numbers given per iteration.
Needs a CUDA device; imports nothing of JAX.
"""

import argparse
import dataclasses
import os
import re
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

CELLS = ("northstar", "fidelity", "config7")
GROUPS = (  # first match wins
    ("adjoint kernel (K1's and K2's backward)", r"warp_vjp_kernel"),
    ("hand kernels (K1-K4)",
     r"warp_pauli_features_kernel|pauli_features_kernel_f64|warp_states_kernel"
     r"|states_kernel_f64|warp_features_kernel|warp_states_fused_kernel"),
    ("eigh (condition numbers)", r"syev|sytrd|stedc|ormtr|steqr|sterf|latrd"),
    ("triangular solves", r"trsm|trsv|trtri"),
    ("Cholesky", r"potrf|potrs"),
    ("GEMM", r"gemm|gemv|xmma|cutlass|Kernel2|dot_kernel"),
    ("elementwise, copies, reductions", r".*"),
)


def _problem(cell, dev):
    from dqgp_tpu_torch.data import split_data_numpy
    from dqgp_tpu_torch.models.circuits import build_circuit
    from dqgp_tpu_torch.models.kernels import QuantumKernelSpec

    if cell == "northstar":
        X, Y, _, _ = cs.make_problem()
        spec = QuantumKernelSpec(
            circuit=build_circuit("chebyshev", cs.NUM_QUBITS, cs.NUM_FEATURES,
                                  cs.NUM_LAYERS),
            kernel_type="projected", outer_kernel="matern")
        return spec, X, Y, split_data_numpy(X, Y, cs.N_AGENTS, "regional"), 42
    if cell == "config7":  # CV scores the seeded subsample, as the driver draws it
        X_tr, Y_tr, _, _, splits = cs.config7_problem(cs.C7_SAMPLES, cs.C7_AGENTS)
        sel = np.random.RandomState(cs.C7_SEED).choice(len(X_tr), cs.C7_CV_MAX, replace=False)
        return cs.config7_spec(), X_tr[sel], Y_tr[sel], splits, cs.C7_SEED
    spec, _, _, _, X_tr, Y_tr, _, _, splits = cs.fidelity_problem(dev)
    return spec, X_tr, Y_tr, splits, cs.FID_SEED


def profile(cell, iters, dev, cond="host", chain=1, grad=None):
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from dqgp_tpu_torch.driver import TrainConfig, _ChunkRunner, _RowLayout, init_admm_state
    from dqgp_tpu_torch.models.gp.cv import FoldIndexBuffers, cv_fold_scores_impl
    from dqgp_tpu_torch.parallel.consensus import make_admm_step, make_agent_batch

    spec, X, Y, splits, seed = _problem(cell, dev)
    cfg = (cs.config7_train_config(1, verbose=False) if cell == "config7"
           else TrainConfig(verbose=False, seed=seed))
    if grad:
        cfg = dataclasses.replace(cfg, grad_method=grad)
    # the chunk's step flags failed factorizations, as the driver's does
    step = make_admm_step(spec, rho=cfg.rho, L=cfg.L, noise_std=cfg.noise_std,
                          compute_cond=cfg.compute_cond and cond == "device",
                          grad_method=cfg.grad_method, psd_fallback=chain == 1)
    batch = make_agent_batch(splits, dev)
    Xt, Yt = torch.as_tensor(X, device=dev), torch.as_tensor(Y, device=dev)
    theta, psi, _ = init_admm_state(len(splits), spec.num_parameters, seed, cfg.rho)
    state = [torch.as_tensor(theta, device=dev), torch.as_tensor(psi, device=dev)]
    folds = FoldIndexBuffers(len(X), cfg.cv_folds, chain, dev)
    folds.fill([seed + 1 + j for j in range(chain)])
    layout = _RowLayout(len(splits), spec.num_parameters, 3 * cfg.cv_folds)

    def one(theta, psi, j):
        out = step(theta, psi, batch)
        scores = cv_fold_scores_impl(spec, Xt, Yt, out.z, *folds.folds(j),
                                     noise_std=cfg.noise_std)
        return out, layout.pack(out, scores)

    if chain > 1:
        runner = _ChunkRunner(one, chain, layout.width, dev, capture=True)

        def iteration():
            _, state[0], state[1] = runner.run(state[0], state[1])
    else:
        def iteration():
            out, row = one(state[0], state[1], 0)
            row.cpu()   # the driver's one fetch
            state[0], state[1] = out.theta, out.psi

    iteration()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            iteration()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / iters
    iters *= chain
    wall_ms /= chain

    by_group = {name: 0.0 for name, _ in GROUPS}
    n_kernels = 0
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        us = e.self_cuda_time_total if us is None else us
        n_kernels += e.count
        for name, pattern in GROUPS:
            if re.search(pattern, e.key):
                by_group[name] += us / 1e3 / iters
                break
    device_ms = sum(by_group.values())
    print(f"{cell} ({cfg.grad_method} gradient, cond {cond}, chain {chain}): wall {wall_ms:.3f} ms/iteration, "
          f"device {device_ms:.3f} ms, "
          f"idle share {1 - device_ms / wall_ms:.3f}, "
          f"{n_kernels / iters:.0f} kernels/iteration")
    for name, ms in sorted(by_group.items(), key=lambda kv: -kv[1]):
        print(f"  {ms:9.3f} ms  {ms / device_ms:6.1%} of the device time  {name}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cell", choices=CELLS + ("all",), default="all")
    ap.add_argument("--iters", type=int, default=None,
                    help="profiled iterations (default 5, 1 for config7)")
    ap.add_argument("--fusion", choices=("auto", "on", "off"), default="auto",
                    help="the fusion switch (default auto)")
    ap.add_argument("--cond", choices=("host", "device"), default="host",
                    help="condition numbers after training (host, train()'s default on "
                         "the card) or in the step (device)")
    ap.add_argument("--chain", type=int, default=1,
                    help="iterations a CUDA-graph replay (default 1: no graph)")
    ap.add_argument("--grad", choices=("central", "streamed", "autodiff"), default=None,
                    help="the gradient (default: the cell's own, central or streamed)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_port: no CUDA device", file=sys.stderr)
        return 1
    from dqgp_tpu_torch import config

    config.set_precision_policy()
    config.use_fusion = args.fusion
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"[{smi}] fusion {args.fusion}")
    for cell in (CELLS if args.cell == "all" else (args.cell,)):
        profile(cell, args.iters or (1 if cell == "config7" else 5), dev, args.cond,
                args.chain, args.grad)
    return 0


if __name__ == "__main__":
    sys.exit(main())
