#!/usr/bin/env python3
"""The port's benchmark: one run of one cell.

    python3 bench_torch/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds ``BENCHMARK.json``, this folder and
the ``dqgp_tpu_torch`` package, on a machine with the cards the cell asks
for. It finds everything by name: the cell in ``BENCHMARK.json``, its
parameters in ``workloads/<name>.json``, its configuration in
``configs/<config>.json``, the code its window drives in
``entries/<entry>.py``, and each metric the cell reports in
``metrics/<metric>.py``. A run

1. builds the cell's inputs from the seed (``traffic.py``), warms up with
   a short unit of the cell's own shapes (the first run in a checkout
   builds the CUDA kernels into ``dqgp_tpu_torch/build/`` there), and
   counts all that as set-up;
2. repeats the unit until at least ``--seconds`` have passed, counting
   whole units only, and closes the window after the last with a
   ``torch.cuda.synchronize()``; with ``--trace 1`` the window's first
   unit runs under ``torch.profiler``;
3. reads the peak of device memory, frees the program's state, and holds
   one unit of the window, drawn from the seed, to the plain reference
   (``reference.py``), number by number against the workload's limits;
4. prints each number compared beside its limit on standard error, and as
   the last line of standard output one JSON object: ``correct``,
   ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics,
   or with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
   ``breakdown``, and last ``checks``.

It exits 2, printing no result, where no card is found or fewer than the
cell asks for; it never falls back to the CPU.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
import types  # noqa: E402

# The host's share of a run (the driver's Python, numpy on the fetched rows)
# runs on two threads: load from one process with few threads keeps the runs
# from moving with what else the machine's shared cores are doing.
HOST_THREADS = 2
for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ.setdefault(_var, str(HOST_THREADS))

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def parse(argv):
    ap = argparse.ArgumentParser(description="One run of one cell of the port's benchmark.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def load_json(path):
    with open(path) as f:
        return json.load(f)


def load_metric(bench_dir: str, name: str):
    path = os.path.join(bench_dir, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(bench: dict, cell: str, trace: int):
    """The metrics a cell reports: its end-to-end ones, or with a trace
    the per-layer ones that name it (or, naming no cell, move one of its
    end-to-end metrics)."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m else m["moves"] in names)]


def device_info(torch, chips: int, dev) -> dict:
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0,
                "power_limit": "none"}
    try:
        power = subprocess.run(
            ["nvidia-smi", "-i", "0", "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip() or "unknown"
    except (OSError, subprocess.SubprocessError):
        power = "unknown"
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": 0, "power_limit": power}


def main(argv=None, *, bench_dir: str = HERE, benchmark_json: str = None,
         require_cuda: bool = True, out=None) -> int:
    """One run; returns the exit code. The CPU tests call it with
    ``require_cuda=False`` on small cells of their own."""
    args = parse(argv)
    out = out or sys.stdout
    bench = load_json(benchmark_json or os.path.join(ROOT, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    cell = cells[args.workload]
    wl = load_json(os.path.join(bench_dir, "workloads", f"{args.workload}.json"))
    cfg = load_json(os.path.join(bench_dir, "configs", f"{cell['config']}.json"))
    if wl["config"] != cell["config"] or wl["traffic"] != cell["traffic"]:
        print(f"workloads/{args.workload}.json does not match BENCHMARK.json", file=sys.stderr)
        return 2

    import torch

    if require_cuda:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            print(f"{args.workload} needs {cell['chips']} CUDA device(s); found "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}: "
                  "no run", file=sys.stderr)
            return 2
        dev = torch.device("cuda", 0)
        torch.set_num_threads(HOST_THREADS)
    else:
        dev = torch.device("cpu")
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    device = device_info(torch, cell["chips"], dev)
    tag = f"[{device['kind']}, {device['count']} device(s), {device['power_limit']}]"

    for path in (ROOT, os.path.dirname(os.path.abspath(bench_dir))):
        if path not in sys.path:
            sys.path.insert(0, path)
    package = os.path.basename(os.path.abspath(bench_dir))
    entries = importlib.import_module(f"{package}.entries.{wl['entry']}")
    trace_mod = importlib.import_module(f"{package}.trace")

    entry = entries.Entry(cfg, wl, args.seed, dev)
    entry.warm_up()
    sync()
    setup_s = time.perf_counter() - T0

    # with --trace 1 the profiler records the window's first unit; the
    # window goes on untraced, and the per-layer metrics that need a time
    # free of the profiler's cost read the units after it
    prof = trace_mod.profiler(dev.type) if args.trace else None
    results, unit_s = [], []
    traced_s = untraced_from = None
    if prof is not None:
        prof.__enter__()
    t0 = time.perf_counter()
    while True:
        t_unit = time.perf_counter()
        results.append(entry.unit(len(results)))
        unit_s.append(time.perf_counter() - t_unit)
        if prof is not None and traced_s is None:
            sync()
            traced_s = time.perf_counter() - t0
            prof.__exit__(None, None, None)
            untraced_from = time.perf_counter()
        if time.perf_counter() - t0 >= args.seconds:
            break
    sync()
    t_end = time.perf_counter()
    window_s = t_end - t0
    tr = trace_mod.read(prof, traced_s) if prof is not None else None
    del prof
    if dev.type == "cuda":
        device["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated(dev))
    failed = sum(not r["finite"] for r in results)

    work = [entry.work(r) for r in results]
    run = types.SimpleNamespace(
        cell=args.workload, cfg=cfg, wl=wl, seed=args.seed, setup_s=setup_s,
        window_s=window_s, units=results, work=sum(work), trace=tr,
        traced_work=work[0] if tr is not None else sum(work),
        untraced_s=t_end - untraced_from if tr is not None else window_s,
        untraced_work=sum(work[1:]) if tr is not None else sum(work),
        counts=importlib.import_module(f"{package}.counts"))
    metrics = {}
    for m in cell_metrics(bench, args.workload, args.trace):
        value = load_metric(bench_dir, m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_check = time.perf_counter()
    try:
        checks = entry.check(results, wl["limits"])
    except Exception:  # a reference that cannot follow the run: not correct
        traceback.print_exc()
        checks = {"reference": {"value": math.inf, "limit": 0.0}}
    correct = failed == 0 and all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                                  for c in checks.values())

    line = {"correct": correct, "attempted": len(results), "failed": failed,
            "metrics": metrics, "device": dict(device)}
    if tr is not None:
        line["device"]["busy_s"] = tr.busy_s()
        line["device"]["window_s"] = tr.window_s
        bd = trace_mod.breakdown(tr)
        if bd is not None:
            line["breakdown"] = bd
    line["checks"] = checks
    print(f"{tag} {args.workload} seed {args.seed}: correct {correct}, "
          f"{len(results)} units ({run.work} of work) in {window_s!r} s, set-up {setup_s!r} s, "
          f"the check {time.perf_counter() - t_check!r} s; unit s first {unit_s[0]!r} min "
          f"{min(unit_s)!r} median {sorted(unit_s)[len(unit_s) // 2]!r} max {max(unit_s)!r}; "
          f"{entry.describe(results)}", file=sys.stderr)
    for name, c in checks.items():
        print(f"{tag} {args.workload} check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    out.write(json.dumps(line) + "\n")
    out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
