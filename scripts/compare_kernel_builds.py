#!/usr/bin/env python
"""Compare the warp kernels built from this tree's ``dqgp_tpu_torch/csrc`` with
those of another tree, on a machine with nvcc and a card.

    python scripts/compare_kernel_builds.py PARENT_CSRC [--time]

PARENT_CSRC is the ``csrc/`` of another commit, e.g. of the parent unpacked
with ``git archive`` into a directory that .gitignore lists
(``_chip_checkout/``). Every warp-kernel source that both trees hold, the
11-12-qubit translation units included, is built with the package's nvcc
flags, one process each, all started together. For each kernel and qubit
count it prints ptxas's report (registers, stack frame, spills) beside the
other tree's, and whether the instantiation's SASS (``cuobjdump -sass``) is
the other tree's, instruction for instruction. With ``--time`` it times K3
and K1 at config #7's step shape (chebyshev 2 layers, B = 108,032) at 10,
11 and 12 qubits from both builds in turns within one call (other, this,
this, other; CUDA events), through the same tables and geometry.
"""

import argparse
import ctypes
import os
import re
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402
from dqgp_tpu_torch.ops import _build  # noqa: E402
from dqgp_tpu_torch.ops import cuda_circuit as K  # noqa: E402

# (kernel, source): the 1-10-qubit sources, then the 11-12-qubit ones
SOURCES = [("K1", K.SOURCE), ("K1_f64", K.SOURCE), ("K2", K.STATES_SOURCE),
           ("K2_f64", K.STATES_SOURCE), ("K3", K.FEATURES_FUSED_SOURCE),
           ("K4", K.FUSED_SOURCE), ("vjp", K.VJP_SOURCE), *K.WIDE_SOURCES.items()]


def build(csrc: str, source: str, out_dir: str):
    """(library path, ptxas log) of ``csrc/source``."""
    lib = os.path.join(out_dir, source.replace(".cu", ".so"))
    proc = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", lib,
                           os.path.join(csrc, source)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed on {csrc}/{source}:\n{proc.stderr}")
    return lib, proc.stdout + proc.stderr


def sass_by_function(lib: str) -> dict:
    """{mangled function name: its SASS instructions} of ``lib``."""
    cuobjdump = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", lib], capture_output=True, text=True,
                          check=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = []
        elif name and "/*" in line:
            out[name].append(line.strip())
    return out


def instantiation_sass(sass: dict, entry: str) -> dict:
    """{qubits: SASS} of the kernel template ``entry``'s instantiations."""
    found = {}
    for name, code in sass.items():
        m = re.search(rf"\d+{entry}ILi(\d+)E", name)
        if m:
            found[int(m.group(1))] = code
    return found


def time_k1_k3(libs: dict, n: int) -> None:
    """K3 and K1 at config #7's step shape, at n qubits, from each tree's
    build, in turns."""
    import numpy as np
    import torch

    dev = torch.device("cuda", 0)
    circuit = cs.config7_spec(n).circuit
    G, B = circuit.num_gates, cs.C7_STEP_ROWS
    angles = (torch.rand((B, G), generator=torch.Generator(device=dev).manual_seed(0),
                         device=dev) * 4.0 - 1.0) * np.pi
    out = torch.empty((B, 3 * n), device=dev)
    ops, gates, members, cperm = K._fused_device_tables(circuit, dev, False)
    n_members = members.shape[0] // (2 if n > K.ONE_WARP_QUBITS else 1)  # then codes
    program = K.fuse_circuit(circuit)
    fgeo, kgeo = K.fused_geometry(circuit), K.features_geometry(circuit)
    table = K._gate_table(circuit, dev)
    stream = torch._C._cuda_getCurrentRawStream(0)
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

    def launcher(lib_path: str, source: str):
        lib = ctypes.CDLL(lib_path)
        if source == K.FEATURES_FUSED_SOURCE:
            fn = lib.dqgp_pauli_features_fused
            fn.argtypes = [vp] * 6 + [i32] * 9 + [i64, vp]
            args = (angles.data_ptr(), cperm.data_ptr(), ops.data_ptr(), gates.data_ptr(),
                    members.data_ptr(), out.data_ptr(), B, n, G, len(program.ops),
                    gates.shape[0], n_members, program.n_su2, cperm.shape[0],
                    fgeo.threads, fgeo.smem_bytes, stream)
        else:
            fn = lib.dqgp_pauli_features
            fn.argtypes = [vp, vp, vp] + [i32] * 4 + [i64, vp]
            args = (angles.data_ptr(), table.data_ptr(), out.data_ptr(), B, G, n,
                    kgeo.threads, kgeo.smem_bytes, stream)

        def launch():
            err = fn(*args)
            if err:
                raise RuntimeError(f"{source} launch failed: CUDA error {err}")
        return launch

    for name, source in (("K3", K.FEATURES_FUSED_SOURCE), ("K1", K.SOURCE)):
        lib = K.kernel_source(name, n)
        other, this = (launcher(libs[t][lib], source) for t in ("other", "this"))
        other_ms, this_ms = cs._alternate_ms([other, this], 20)
        print(f"{name} at B={B}, n={n}, G={G}: other tree {other_ms:.4f} ms, this tree "
              f"{this_ms:.4f} ms a launch (other, this, this, other)", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other_csrc", help="the other tree's dqgp_tpu_torch/csrc")
    ap.add_argument("--time", action="store_true", help="time K3 and K1 from both builds")
    args = ap.parse_args()
    trees = {"other": os.path.abspath(args.other_csrc), "this": str(_build.CSRC_DIR)}
    sources = sorted({s for _, s in SOURCES
                      if all(os.path.exists(os.path.join(t, s)) for t in trees.values())})
    with tempfile.TemporaryDirectory() as tmp:
        jobs = [(t, s) for t in trees for s in sources]
        for t in trees:
            os.makedirs(os.path.join(tmp, t))
        with ThreadPoolExecutor(len(jobs)) as pool:
            built = dict(zip(jobs, pool.map(
                lambda j: build(trees[j[0]], j[1], os.path.join(tmp, j[0])), jobs)))
        sass = {j: sass_by_function(lib) for j, (lib, _) in built.items()}
        same_everywhere, compared = True, [0, 0]  # instantiations, instructions
        for name, source in SOURCES:
            if source not in sources:
                continue
            entry = cs.WARP_KERNELS[name]
            reports = {t: cs.warp_ptxas(built[(t, source)][1], entry) for t in trees}
            codes = {t: instantiation_sass(sass[(t, source)], entry) for t in trees}
            rows = []
            for n in sorted(set(reports["this"]) | set(reports["other"])):
                mine, theirs = codes["this"].get(n), codes["other"].get(n)
                same = bool(mine) and mine == theirs
                same_everywhere &= same
                compared[0] += same
                compared[1] += len(mine) if same else 0
                rows.append(f"{n}: {reports['this'].get(n)} vs {reports['other'].get(n)}"
                            f"{'' if same else ' (SASS differs)'}")
            print(f"{name} ({source}), this tree vs the other (registers, stack B, spill "
                  f"stores B, spill loads B): " + "; ".join(rows), flush=True)
        print(f"SASS of every instantiation both trees build: "
              f"{'identical' if same_everywhere else 'differs where marked'} ({compared[0]} "
              f"instantiations, {compared[1]} instructions identical)", flush=True)
        if args.time:
            for n in (cs.C7_QUBITS, *cs.WIDE_QUBITS):
                time_k1_k3({t: {s: built[(t, s)][0] for s in sources} for t in trees}, n)


if __name__ == "__main__":
    main()
