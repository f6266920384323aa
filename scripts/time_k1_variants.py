#!/usr/bin/env python
"""What moves the float32 Pauli-feature kernel (K1) at the north-star step
shape (chebyshev 4 qubits x 3 layers, G=40, B=84,240), on a GPU.

    python scripts/time_k1_variants.py
    python scripts/time_k1_variants.py --first-layout-csrc DIR

Times, in turns within one process (CUDA events a call, and the kernel alone
from torch.profiler), the kernel as the package launches it against
diagnostic variants of it. Variants of the launch, on the package's own
build:

* ``256-thread blocks``: the block size the other warp kernels use;
* ``N blocks an SM``: the dynamic shared memory a block asks for inflated so
  that only N 128-thread blocks are resident on an SM. At 4 (K2's 16 warps an
  SM) the step's 2,633 warps take two rounds, the second a quarter full.

Variants of the source, each built from a patched copy of ``csrc/`` (the
patterns must be found, or the script stops):

* ``fast trig``: ``__sincosf`` in ``apply_gate`` in place of ``sin_cos``
  (what the trig's latency costs; not accurate enough to keep);
* ``no write-out``: only sample 0 writes its features;
* ``row staging``: a warp's angle rows staged row by row, as at 6 qubits and
  above, in place of the flat staging.

With ``--first-layout-csrc`` it also times the kernel's first layout (one
thread a sample, the state in shared memory) from a directory that holds
that ``pauli_features.cu`` and ``statevector.cuh``, e.g.

    git show <commit>:dqgp_tpu_torch/csrc/pauli_features.cu > DIR/pauli_features.cu
    git show <commit>:dqgp_tpu_torch/csrc/statevector.cuh > DIR/statevector.cuh

Every variant's features are held to the plain version first (5e-6; the fast
trig at 1e-3). Prints the card's name and power limit, then one line a
variant. Needs a CUDA device; imports nothing of JAX.
"""

import argparse
import ctypes
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

# (variant, file, pattern, replacement)
PATCHES = (
    ("fast trig", "warp_state.cuh",
     "if (kind != H && kind != CZ) sin_cos(0.5f * a, &s, &c);",
     "if (kind != H && kind != CZ) __sincosf(0.5f * a, &s, &c);"),
    ("no write-out", "pauli_features.cu",
     "out + (long long)b * (3 * N), b < B);", "out + (long long)b * (3 * N), b == 0);"),
    ("row staging", "warp_state.cuh",
     "if constexpr (Geo::kL == 1) {", "if constexpr (false) {"),
)
REPS = 50  # launches a CUDA-event timing
_vp, _i32, _i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
WARP_ARGS = [_vp, _vp, _vp] + [_i32] * 4 + [_i64, _vp]
FIRST_LAYOUT_ARGS = [_vp, _vp, _vp] + [_i32] * 5 + [_i64, _vp]


def build_variant(tag: str, csrc: str, patch=None):
    """nvcc ``csrc``/pauli_features.cu (a patched copy of the directory if
    ``patch``) into the package's build directory; returns its launch."""
    from dqgp_tpu_torch.ops import _build

    work = os.path.join(_build.BUILD_DIR, "variants", tag.replace(" ", "_"))
    shutil.rmtree(work, ignore_errors=True)
    shutil.copytree(csrc, work)
    if patch:
        name, pattern, replacement = patch
        path = os.path.join(work, name)
        with open(path) as f:
            text = f.read()
        if text.count(pattern) != 1:
            raise SystemExit(f"{tag}: pattern not found once in {name}: {pattern!r}")
        with open(path, "w") as f:
            f.write(text.replace(pattern, replacement))
    lib = os.path.join(work, "k1.so")
    proc = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", lib,
                           os.path.join(work, "pauli_features.cu")],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"{tag}: nvcc failed:\n{proc.stderr}")
    return ctypes.CDLL(lib).dqgp_pauli_features


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--first-layout-csrc", default=None,
                    help="directory with the first layout's pauli_features.cu and statevector.cuh")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_k1_variants: no CUDA device", file=sys.stderr)
        return 1
    from concurrent.futures import ThreadPoolExecutor

    from dqgp_tpu_torch.models.circuits import build_circuit
    from dqgp_tpu_torch.ops import _build
    from dqgp_tpu_torch.ops import cuda_circuit as K

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)

    circuit = build_circuit("chebyshev", cs.NUM_QUBITS, cs.NUM_FEATURES, cs.NUM_LAYERS)
    n, G = circuit.num_qubits, circuit.num_gates
    geo = K.features_geometry(circuit)
    gates = K._gate_table(circuit, dev)
    jobs = [(tag, str(_build.CSRC_DIR), patch) for tag, *patch in PATCHES]
    if args.first_layout_csrc:
        jobs.append(("first layout", os.path.abspath(args.first_layout_csrc), None))
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = dict(zip([j[0] for j in jobs], pool.map(lambda j: build_variant(*j), jobs)))
    package = K._library(K.SOURCE).dqgp_pauli_features

    def smem_for(threads: int) -> int:
        return K._warp_geometry(n, 3 * G, 0, G, "K1", 1, threads).smem_bytes

    def launch(fn, angles, *geometry):
        out = torch.empty((angles.shape[0], 3 * n), dtype=torch.float32, device=dev)
        err = fn(angles.data_ptr(), gates.data_ptr(), out.data_ptr(), angles.shape[0], G, n,
                 *geometry, torch._C._cuda_getCurrentRawStream(0))
        if err != 0:
            raise RuntimeError(f"launch failed: CUDA error {err}")
        return out

    # variant -> (launch function, geometry arguments, tolerance)
    variants = {"as launched (128-thread blocks, flat staging)":
                (package, (geo.threads, geo.smem_bytes), cs.K1_TOL),
                "256-thread blocks": (package, (256, smem_for(256)), cs.K1_TOL)}
    for blocks in (4, 2):
        smem = 227 * 1024 // blocks - 1024
        per_sm = K._library(K.SOURCE).dqgp_pauli_features_blocks_per_sm(n, geo.threads, smem)
        cs.check(per_sm == blocks, f"{smem} B of shared memory hold {per_sm} blocks an SM")
        variants[f"{blocks} blocks an SM ({blocks * geo.threads // 32} warps)"] = (
            package, (geo.threads, smem), cs.K1_TOL)
    for tag, fn in built.items():
        if tag == "first layout":
            fn.argtypes, fn.restype = FIRST_LAYOUT_ARGS, _i32
            # the first layout's launch_config: 128 threads, halved until the
            # states and the angle rows fit 200 KB
            tpb = 128
            while tpb > 1 and tpb * 4 * (2 * (1 << n) + (G | 1)) > 200 * 1024:
                tpb //= 2
            variants[tag] = (fn, (tpb, G | 1, tpb * 4 * (2 * (1 << n) + (G | 1))), cs.K1_TOL)
        else:
            fn.argtypes, fn.restype = WARP_ARGS, _i32
            variants[tag] = (fn, (geo.threads, geo.smem_bytes),
                             1e-3 if tag == "fast trig" else cs.K1_TOL)

    gen = torch.Generator(device=dev).manual_seed(0)
    for B in (cs.STEP_ROWS, cs.N_SAMPLES):
        a = (torch.rand((B, G), generator=gen, device=dev) * 4.0 - 1.0) * torch.pi
        want = K.pauli_features_reference(circuit, a)
        calls = {}
        for tag, (fn, geometry, tol) in variants.items():
            got = launch(fn, a, *geometry)
            torch.cuda.synchronize()
            err = float((got - want).abs().max()) if tag != "no write-out" else float(
                (got[0] - want[0]).abs().max())
            cs.check(err <= tol, f"{tag} at B={B}: max abs diff {err} > {tol}")
            calls[tag] = (lambda fn=fn, geometry=geometry: launch(fn, a, *geometry))
        event_ms = cs._alternate_ms(list(calls.values()), REPS)
        bound_ms, bound_by = cs.k1_bound(circuit, B)
        print(f"K1 at B={B} n={n} G={G} [{smi}], bound {bound_ms:.5f} ms ({bound_by}):")
        for (tag, call), ms in zip(calls.items(), event_ms):
            alone = cs._device_ms(call, 20)
            print(f"  {tag}: {ms:.4f} ms a call, {alone:.4f} ms the kernel alone "
                  f"({bound_ms / alone:.1%} of the bound)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
