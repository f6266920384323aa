// Pauli-feature kernel (K1) for Hopper (sm_90a).
//
// Replaces dqgp_tpu/ops/pallas_circuit.py::make_pallas_pauli_features_fn:
// per sample, run the encoding circuit's gate sequence on |0...0> and reduce
// each qubit q to <X_q>, <Y_q>, <Z_q>. angles (B, G) -> features (B, 3n),
// laid out [X_0..X_{n-1} | Y_0.. | Z_0..], in float32 (the production path,
// like the Pallas kernel) or float64 (the reference-grade path that the JAX
// package runs through its complex128 XLA engine).
//
// What bounds it on this card: by the roofline, bytes at the north star's 4
// qubits (a sample reads a 160 B angle row and writes a 48 B feature row:
// 17.5 MB for the step's 84,240 samples, 5 us at the card's memory rate,
// against 4.9 us for its 3.3e8 operations) and operations from 5 qubits up.
// What it waits for in practice is latency: the step is a single round of
// resident warps, each running its 40 gates back to back, every gate a sine,
// a cosine and 8 amplitude pairs of 4-8 multiply-adds behind a dispatch on
// the gate's kind and qubit.
//
// Design, float32 (warp_pauli_features_kernel): a sample's state lives in
// registers across a lane group (warp_state.cuh: a lane a sample at n <= 5,
// 2^(n-5) lanes above, a whole warp a sample at 10 qubits), and the kernel
// applies the circuit's gates one at a time, in the circuit's order, through
// apply_gate (run_gate_batch, the batch loop it shares with the states
// kernel K2), then reduces the registers to the features (reduce_features,
// the reduction it shares with the fused kernel K3). Qubit q lies on bit q
// of the state's index, as in K3: bits 0-4 in a lane's registers, 5-9 across
// the lanes, where the reduction pairs amplitudes by shuffle. Shared memory
// holds the gate table and each warp's staged angle rows (loaded coalesced,
// at an odd stride); no state, so the block size no longer depends on the
// qubit count. Blocks are persistent: each loads the gate table once, then
// its warps walk the batch a warp-sized group of samples at a time. The
// kernel is templated on n (1..12), so every register index is a
// compile-time constant; up to 4 qubits it is held to 64 registers a thread
// (GateFeaturesMinBlocks: 32 resident warps an SM), which takes the
// north-star step's 2,633 warps in one round, in 128-thread blocks so that
// they spread evenly over the SMs (ops/cuda_circuit.py::features_geometry).
// ptxas reports no stack frame and no spills for any of the ten
// (chip_smoke.py's phase 2 fails otherwise). Trig is warp_state.cuh's
// sin_cos (sincosf's algorithm, no fast-math intrinsics): features are held
// to the plain PyTorch engine at 5e-6.
//
// At 11 and 12 qubits (pauli_features_q11_12.cu, pauli_features_f64_q11_12.cu)
// a sample spans 2 and 4 warps, 32 amplitudes a lane as at 10 qubits: a gate
// on qubit 10 or 11 trades amplitudes with the partner warp through shared
// memory (warp_state.cuh's su2_warp, perm_warp), and the reduction adds the
// warps' shares there before the row is written.
//
// Design, float64 (warp_pauli_features_f64_kernel): the float32 design in
// complex128, through the same batch loop, gate bodies and reduction
// (warp_state.cuh, templated on the real type) and the same geometry and
// bit map: A = min(2^n, 32) amplitudes a lane, a lane a sample up to 5
// qubits, a warp a sample at 10. A lane's state is 4 x 2^n registers: up
// to 4 qubits two blocks an SM (F64MinBlocks, 128 registers a thread), from
// 5 qubits up 128 registers of state and one block an SM (up to 255
// registers a thread, as the adjoint kernel's two float32 states). Shuffles
// of a double are two 32-bit shuffles. Trig is warp_state.cuh's float64
// sin_cos (CUDA's sincos, without its local array): features are held to
// the plain engine at 1e-12. It runs for float64 features: the condition-
// number backfill (driver.host_condition_numbers), 16 z rows of an agent a
// launch. Its first layout (one thread a sample, the state in shared
// memory) stays in circuit_f64_first_layout.cu for chip_smoke.py's timing
// only.
//
// Interface: plain C, loaded with ctypes. The launches return
// cudaGetLastError(), which the Python wrapper checks.

#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_state.cuh"

namespace {

using namespace dqgp::warp;

// float32: gates points at the (G, 3) int32 table [kind, qubit, control]
// (qubit q on bit q), out at (B, 3N) float32.
template <int N>
__global__ void __launch_bounds__(kMaxThreads, GateFeaturesMinBlocks<N>::value)
warp_pauli_features_kernel(const float* __restrict__ angles,
                           const int* __restrict__ gates,
                           float* __restrict__ out, int B, int G) {
  // each lane of the sample writes its share of the features straight to
  // the output row (4 MB at the north-star step: no staging for them)
  run_gate_batch<N>(angles, gates, B, G,
                    [out, B](const float (&re)[Geometry<N>::kA],
                             const float (&im)[Geometry<N>::kA], int lig, int b,
                             const Staged&) {
    reduce_features<N>(re, im, lig, out + (long long)b * (3 * N), b < B);
  });
}

// float64: the same, in complex128; out at (B, 3N) float64.
template <int N>
__global__ void __launch_bounds__(kMaxThreads, F64MinBlocks<N>::value)
warp_pauli_features_f64_kernel(const double* __restrict__ angles,
                               const int* __restrict__ gates,
                               double* __restrict__ out, int B, int G) {
  using Geo = Geometry<N, double>;
  run_gate_batch<N>(angles, gates, B, G,
                    [out, B](const double (&re)[Geo::kA], const double (&im)[Geo::kA],
                             int lig, int b, const StagedT<double>&) {
    reduce_features<N>(re, im, lig, out + (long long)b * (3 * N), b < B);
  });
}

}  // namespace

// The qubit counts this translation unit instantiates, in float32 and in
// float64: 1-10 here. pauli_features_q11_12.cu and
// pauli_features_f64_q11_12.cu include this file with their own lists (11
// and 12 qubits, a sample across 2 and 4 warps), so that nvcc builds them
// beside this one, in parallel.
#ifndef DQGP_F32_QUBITS
#define DQGP_F32_QUBITS(X) X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8) X(9) X(10)
#endif
#ifndef DQGP_F64_QUBITS
#define DQGP_F64_QUBITS(X) X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8) X(9) X(10)
#endif

extern "C" {

// angles points at a (B, G) float32 tensor, gates at the (G, 3) int32 table
// [kind, qubit, control], out at a (B, 3n) float32 tensor. Returns
// cudaGetLastError().
int dqgp_pauli_features(const float* angles, const int* gates, float* out,
                        int B, int G, int n, int tpb, long long smem_bytes,
                        void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (n) {
#define DQGP_CASE(N)                                                                 \
  case N:                                                                            \
    return launch_groups(warp_pauli_features_kernel<N>, Geometry<N>::kSamples,       \
                         Geometry<N>::kW, B, tpb, smem_bytes, s, angles, gates, out, \
                         B, G);
    DQGP_F32_QUBITS(DQGP_CASE)
#undef DQGP_CASE
  }
  return (int)cudaErrorInvalidValue;
}

// Resident blocks an SM holds of the n-qubit float32 instantiation at this
// block size and shared memory (-1 on error).
int dqgp_pauli_features_blocks_per_sm(int n, int tpb, long long smem_bytes) {
  switch (n) {
#define DQGP_CASE(N) \
  case N:            \
    return blocks_per_sm(warp_pauli_features_kernel<N>, tpb, smem_bytes);
    DQGP_F32_QUBITS(DQGP_CASE)
#undef DQGP_CASE
  }
  return -1;
}

// The float64 instantiations: angles (B, G) float64, the same gate table,
// out (B, 3n) float64. Returns cudaGetLastError().
int dqgp_pauli_features_f64(const double* angles, const int* gates, double* out,
                            int B, int G, int n, int tpb, long long smem_bytes,
                            void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (n) {
#define DQGP_CASE(N)                                                                \
  case N:                                                                           \
    return launch_groups(warp_pauli_features_f64_kernel<N>,                         \
                         Geometry<N, double>::kSamples, Geometry<N, double>::kW, B, \
                         tpb, smem_bytes, s, angles, gates, out, B, G);
    DQGP_F64_QUBITS(DQGP_CASE)
#undef DQGP_CASE
  }
  return (int)cudaErrorInvalidValue;
}

int dqgp_pauli_features_f64_blocks_per_sm(int n, int tpb, long long smem_bytes) {
  switch (n) {
#define DQGP_CASE(N) \
  case N:            \
    return blocks_per_sm(warp_pauli_features_f64_kernel<N>, tpb, smem_bytes);
    DQGP_F64_QUBITS(DQGP_CASE)
#undef DQGP_CASE
  }
  return -1;
}

const char* dqgp_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
