#!/usr/bin/env python3
"""The readings a cell's limits are set from: the program's numbers on a
dozen seeds or more (the lower readings), the control's on three or more,
and each planted fault's (the upper readings). The benchmark's runs do not
run this.

    python3 bench_torch/calibrate.py --workload <name> [--seeds 12]
        [--control-seeds 3] [--fault-seeds 3] [--first-seed 1000] [--out FILE]

Training cells run the window's own call, ``driver.train``, for the
``ref_steps + 1`` iterations the check reads, on the cell's data: the
program as the configuration states it; the control, the program's own
float32 GP path (``gp_dtype`` and ``cv_dtype`` "float32", the step below
the configuration's float64); and each fault of ``faults.py``. Posterior
cells run one posterior of the cell: the program; the control, the
reference in TF32 (its Grams' products from operands rounded to TF32, its
solve in float32: the step below the configuration's float32) in the
program's place; and each fault. Each line printed is one reading; the last
is a JSON summary, also written to ``--out``.
"""

import argparse
import json
import math
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:0] = [ROOT]

import numpy as np  # noqa: E402
import torch  # noqa: E402

from bench_torch import faults, reference as R, traffic  # noqa: E402
from bench_torch.entries import posterior as post_entry  # noqa: E402
from bench_torch.entries import train as train_entry  # noqa: E402

NO_LIMITS = {k: math.inf for k in ("loss", "cv", "step", "cond", "mean", "var")}


def train_reading(cfg, wl, seed, dev, overrides=None, fault=None):
    steps = int(wl["ref_steps"])
    ov = {"max_iter": steps + 1, "cv_patience": steps + 1, **(overrides or {})}
    e = train_entry.Entry(cfg, wl, seed, dev, ov)
    admm_seed = traffic.small_seed(seed, 4, 0)
    if fault:
        with faults.train_fault(fault):
            res = e.run(admm_seed)
    else:
        res = e.run(admm_seed)
    nums = train_entry.compare(cfg, wl, e.splits, e.X, e.Y, res, dev, NO_LIMITS)
    return {k: v["value"] for k, v in nums.items()}


def control_posterior(cfg, p, X, Y, theta, dev):
    """The reference's posterior in TF32: float32 features, Gram products
    from TF32-rounded operands, a float32 Cholesky and solves."""
    n = p["train_rows"]
    circ = R.Circuit(cfg["circuit"], dev)
    F = faults.tf32(circ.features(torch.as_tensor(X, device=dev),
                                  torch.as_tensor(theta, device=dev), torch.float32))
    Ftr, Fte = F[:n], F[n:]
    K = R.matern(Ftr, Ftr)
    Ks = R.matern(Fte, Ftr)
    mean, var = R.posterior(K, faults.tf32(Ks), torch.ones(len(Fte), device=dev),
                            torch.as_tensor(Y, device=dev).float(), p["noise_std"] ** 2
                            + p["jitter"])
    return mean.double().cpu().numpy(), var.double().cpu().numpy()


def posterior_reading(cfg, wl, seed, dev, control=False, fault=None):
    e = post_entry.Entry(cfg, dict(wl, pool=1), seed, dev)
    X, Y, theta = e.pool[0][:3]
    if control:
        mean, var = control_posterior(cfg, e.post, X, Y, theta, dev)
        ref_m, ref_v = post_entry.exact_posterior(cfg, e.post, X, Y, theta, dev)
        return {"mean": post_entry.worst_gap(mean, ref_m),
                "var": post_entry.worst_gap(var, ref_v)}
    if fault:
        with faults.posterior_fault(fault):
            r = e.unit(0)
    else:
        r = e.unit(0)
    out = {k: v["value"] for k, v in e.check([r], NO_LIMITS).items()}
    out["cg_iterations"] = r["cg_iterations"]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--fault-seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=1000)
    ap.add_argument("--faults", default="all", help="comma-separated, or all, or none")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    wl = json.load(open(os.path.join(HERE, "workloads", f"{args.workload}.json")))
    cfg = json.load(open(os.path.join(HERE, "configs", f"{wl['config']}.json")))
    is_train = wl["entry"] == "train"
    kinds = faults.FAULTS
    if args.faults == "none":
        kinds = ()
    elif args.faults != "all":
        kinds = tuple(args.faults.split(","))
    s0 = args.first_seed
    out = {"workload": args.workload, "program": [], "control": [], "faults": {}}

    def show(kind, seed, nums, t):
        print(json.dumps({"kind": kind, "seed": seed, "seconds": round(t, 3), **nums}),
              flush=True)

    for i in range(args.seeds):
        t = time.perf_counter()
        nums = (train_reading(cfg, wl, s0 + i, dev) if is_train
                else posterior_reading(cfg, wl, s0 + i, dev))
        show("program", s0 + i, nums, time.perf_counter() - t)
        out["program"].append(nums)
    for i in range(args.control_seeds):
        t = time.perf_counter()
        seed = s0 + 100 + i
        nums = (train_reading(cfg, wl, seed, dev, {"gp_dtype": "float32", "cv_dtype": "float32"})
                if is_train else posterior_reading(cfg, wl, seed, dev, control=True))
        show("control", seed, nums, time.perf_counter() - t)
        out["control"].append(nums)
    for kind in kinds:
        out["faults"][kind] = []
        for i in range(args.fault_seeds):
            t = time.perf_counter()
            seed = s0 + 200 + i
            nums = (train_reading(cfg, wl, seed, dev, fault=kind) if is_train
                    else posterior_reading(cfg, wl, seed, dev, fault=kind))
            show(f"fault:{kind}", seed, nums, time.perf_counter() - t)
            out["faults"][kind].append(nums)

    names = sorted({k for r in out["program"] for k in r if k != "cg_iterations"})
    summary = {}
    for k in names:
        s = {"lower": max(r[k] for r in out["program"])}
        if out["control"]:
            s["control"] = min(r[k] for r in out["control"])
        for kind, rows in out["faults"].items():
            s[kind] = min(r[k] for r in rows)
        summary[k] = s
    out["summary"] = summary
    if torch.cuda.is_available() and dev.type == "cuda":
        out["device"] = torch.cuda.get_device_name(0)
    line = json.dumps(out)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(json.dumps({"summary": summary}))
    return 0


if __name__ == "__main__":
    np.seterr(all="ignore")
    sys.exit(main())
