#!/usr/bin/env python
"""What moves the adjoint kernel (csrc/circuit_vjp.cu, the backward of K1
and K2) at the three autodiff steps' shapes (chip_smoke.VJP_SHAPES: the
north star's B=1,040 at 4 qubits, config #5's B=900 at 6, config #7's
B=54,016 at 10), on a GPU.

    python scripts/time_vjp_variants.py

Times, in turns within one process (CUDA events a call, and the kernel alone
from torch.profiler), the kernel as the package launches it against
variants of it. Variants of the source, each built from a patched copy of
``csrc/`` (the patterns must be found, or the script stops), with ptxas's
registers, stack and spills of the instantiation timed:

* ``two blocks an SM``: every instantiation held to 128 registers a thread
  (VjpMinBlocks 2: 16 warps an SM), as the forward kernels are, in place of
  one block of up to 255 registers from 5 qubits up;
* ``gate-by-gate reduction``: where a sample spans lanes, each rotation's
  partial gradients summed over the lane group by an xor butterfly as the
  walk goes (and one lane of the group writing the sum over the gate's
  angle), in place of each lane's partials kept in shared memory and summed
  once after the walk;
* ``fast trig``: ``__sincosf`` in place of ``sin_cos`` in the backward walk
  (what the trig's latency costs; not accurate enough to keep);
* ``no generator sums``: each rotation's Im <lambda|P|phi> over the lane
  group (the generator's pass over the registers, its shuffles where the
  target is a lane bit, and the lane reduction) replaced by one product of
  the two states' first registers, which keeps both states' inverse gates
  live (what the gradient's sums cost; its output is not the gradient).

A variant of the launch, on the package's build: ``32-thread blocks`` (one
warp a block, so that a small batch's warps spread over as many SMs as
there are warps).

Each variant's gradient is held to the package kernel's first (VJP_TOL of
max(1, max |g|); the fast trig at 1e-3; the no-generator-sums variant is
not held). Prints the card's name and power limit, then one line a variant
and shape. Needs a CUDA device; imports nothing of JAX.
"""

import ctypes
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

# variant -> (file, ((pattern, replacement), ...)) in csrc/
PATCHES = {
    "two blocks an SM": ("circuit_vjp.cu", (
        ("static constexpr int value = N <= 4 ? 2 : 1;", "static constexpr int value = 2;"),)),
    "gate-by-gate reduction": ("circuit_vjp.cu", (
        ("        part[j] = d;",
         "        d = group_sum<Geo::kL>(d);\n"
         "        __syncwarp();\n"
         "        if (lig == (j & (Geo::kL - 1))) st.row[j] = 0.5f * d;"),
        ("    __syncwarp();\n    if constexpr (Geo::kL > 1) {",
         "    __syncwarp();\n    if constexpr (false) {"))),
    "fast trig": ("circuit_vjp.cu", (
        ("if (has_angle(kind)) sin_cos(0.5f * a, &s, &c);",
         "if (has_angle(kind)) __sincosf(0.5f * a, &s, &c);"),)),
    "no generator sums": ("circuit_vjp.cu", (
        ("""        if (kind == RZ || kind == CRZ || kind == RZZ) {
          d = generator_diag<N>(pr, pi, lr, li, kind == RZZ, q, ctl, lig);
        } else if (kind == RY || kind == CRY) {
          d = generator_xy<N, true>(pr, pi, lr, li, q, lig, make_control(ctl, lig));
        } else {
          d = generator_xy<N, false>(pr, pi, lr, li, q, lig, make_control(ctl, lig));
        }""", "        d = lr[0] * pi[0] - li[0] * pr[0];"),)),
}
MIN_BLOCKS = {"two blocks an SM": lambda n: 2}
_vp, _i32, _i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
VJP_ARGS = [_vp] * 4 + [_i32] * 5 + [_i64, _vp]


def build_variant(tag: str):
    """nvcc a copy of ``csrc/`` with ``tag``'s patches into the package's
    build directory; returns (launch function, ptxas log)."""
    from dqgp_tpu_torch.ops import _build

    work = os.path.join(_build.BUILD_DIR, "vjp_variants", tag.replace(" ", "_"))
    shutil.rmtree(work, ignore_errors=True)
    shutil.copytree(_build.CSRC_DIR, work)
    name, patches = PATCHES[tag]
    path = os.path.join(work, name)
    with open(path) as f:
        text = f.read()
    for pattern, replacement in patches:
        if text.count(pattern) != 1:
            raise SystemExit(f"{tag}: pattern not found once in {name}: {pattern!r}")
        text = text.replace(pattern, replacement)
    with open(path, "w") as f:
        f.write(text)
    lib = os.path.join(work, "vjp.so")
    proc = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", lib,
                           os.path.join(work, "circuit_vjp.cu")],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"{tag}: nvcc failed:\n{proc.stderr}")
    fn = ctypes.CDLL(lib).dqgp_circuit_vjp
    fn.argtypes, fn.restype = VJP_ARGS, _i32
    return fn, proc.stdout + proc.stderr


def main() -> int:
    if not torch.cuda.is_available():
        print("time_vjp_variants: no CUDA device", file=sys.stderr)
        return 1
    from concurrent.futures import ThreadPoolExecutor

    from dqgp_tpu_torch.ops import _build
    from dqgp_tpu_torch.ops import cuda_circuit as K

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    _, package_log = _build.build(K.VJP_SOURCE)
    with ThreadPoolExecutor(len(PATCHES)) as pool:
        built = dict(zip(PATCHES, pool.map(build_variant, PATCHES)))
    ptxas = {tag: cs.warp_ptxas(log, "warp_vjp_kernel") for tag, (_, log) in built.items()}
    ptxas["as launched"] = cs.warp_ptxas(package_log, "warp_vjp_kernel")  # empty on reuse
    package = K._library(K.VJP_SOURCE).dqgp_circuit_vjp

    gen = torch.Generator(device=dev).manual_seed(0)
    for what, B, output in cs.VJP_SHAPES:
        circuit = cs.vjp_shape_circuit(what)
        n, G = circuit.num_qubits, circuit.num_gates
        states = output == "states"
        gates = K._gate_table(circuit, dev, states)
        a = (torch.rand((B, G), generator=gen, device=dev) * 4.0 - 1.0) * torch.pi
        if states:
            cot = torch.view_as_real(torch.randn((B, circuit.dim), generator=gen, device=dev,
                                                 dtype=torch.complex64)).contiguous()
        else:
            cot = torch.rand((B, 3 * n), generator=gen, device=dev) * 2 - 1

        def geometry(min_blocks, threads):
            geo = K.vjp_geometry(circuit, min_blocks, threads)
            return geo.threads, geo.smem_bytes

        package_geo = K.vjp_geometry(circuit)
        # variant -> (launch function, (threads, smem), tolerance or None)
        variants = {"as launched": (package, (package_geo.threads, package_geo.smem_bytes),
                                    cs.VJP_TOL),
                    "32-thread blocks": (package, geometry(K.vjp_min_blocks(n), 32), cs.VJP_TOL)}
        for tag, (fn, _) in built.items():
            variants[tag] = (fn, geometry(MIN_BLOCKS.get(tag, K.vjp_min_blocks)(n),
                                          package_geo.threads),
                             {"fast trig": 1e-3, "no generator sums": None}.get(tag, cs.VJP_TOL))

        def launch(fn, geo):
            grad = torch.empty_like(a)
            err = fn(a.data_ptr(), gates.data_ptr(), cot.data_ptr(), grad.data_ptr(), B, G, n,
                     int(states), *geo, torch._C._cuda_getCurrentRawStream(0))
            if err != 0:
                raise RuntimeError(f"launch failed: CUDA error {err}")
            return grad

        want = launch(package, variants["as launched"][1])
        torch.cuda.synchronize()
        scale = max(1.0, float(want.abs().max()))
        calls = {}
        for tag, (fn, geo, tol) in variants.items():
            got = launch(fn, geo)
            torch.cuda.synchronize()
            err = float((got - want).abs().max()) / scale
            cs.check(tol is None or err <= tol, f"{tag} at {what}: {err} > {tol}")
            calls[tag] = (lambda fn=fn, geo=geo: launch(fn, geo))
        reps = 3 if n == 10 else 20
        event_ms = cs._alternate_ms(list(calls.values()), reps)
        bound_ms, bound_by = cs.vjp_bound(circuit, B, output)
        print(f"adjoint at {what}: B={B} n={n} G={G} {output} [{smi}], bound {bound_ms:.5f} ms "
              f"({bound_by}):")
        for (tag, call), ms in zip(calls.items(), event_ms):
            alone = cs._device_ms(call, reps)
            regs = ptxas.get(tag if tag in built else "as launched", {}).get(n)
            print(f"  {tag}: {ms:.4f} ms a call, {alone:.4f} ms the kernel alone "
                  f"({bound_ms / alone:.2%} of the bound); ptxas (registers, stack B, spill "
                  f"stores B, spill loads B) {regs}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
