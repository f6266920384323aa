// Fused-program Pauli-feature kernel (K3) for Hopper (sm_90a).
//
// Replaces dqgp_tpu/ops/pallas_circuit.py::make_pallas_pauli_features_fused_fn:
// per sample, run the gate-fused op program of dqgp_tpu_torch/ops/fusion.py
// on |0...0> and reduce each qubit q to <X_q>, <Y_q>, <Z_q>. Angles (B, G)
// float32 -> features (B, 3n) float32 laid out [X_0..X_{n-1} | Y_0.. |
// Z_0..], as K1 lays them out. float32 only, as the Pallas kernel is. Like
// the TPU function, which builds its packed coefficient rows from the angles
// (fusion.packed_inputs) inside the same call, the kernel forms each SU2
// op's fused 2x2 from its gates' angles itself, in fusion.su2_products'
// order (each new gate multiplied on the left), and reads each phase run's
// member angles (pi for a CZ) straight from the angle row.
//
// What bounds it on this card: FP32 issue. At config #7's 10 qubits a sample
// costs about 4.9e5 floating-point operations (chip_smoke.py counts them: 30
// SU2 ops over 512 amplitude pairs, two 10-term phase runs with a sine and a
// cosine per amplitude, the reduction) against 400 bytes of device memory.
// The lanes also trade ~1,400 shuffles a sample, which that bound omits.
//
// Design: the fused program's body is warp_program.cuh's, shared with the
// fused states kernel (K4); this kernel adds the reduction. A sample's state
// lives in registers across a lane group (warp_state.cuh): at 10 qubits a
// whole warp holds one sample, 32 complex amplitudes a lane, and gates on
// qubits 5..9 trade amplitudes through __shfl_xor_sync; at n <= 5 a lane
// holds a whole sample. Shared memory holds only the tables, the
// phase-pattern matrix C (permuted so that the lanes of a group read
// consecutive words) and, per warp, its samples' staged rows (angles loaded
// coalesced, at an odd stride, and the SU2 ops' 2x2s, which the lanes of a
// sample build in turn). Each lane writes its share of the features straight
// from the reduction. Blocks are persistent: each loads the tables once,
// then its warps walk the batch a warp-sized group of samples at a time,
// with no barrier after the tables are loaded. The kernel is templated on n
// (1..12), so every register index is a compile-time constant, and ptxas
// reports no stack frame and no spills for any of the twelve. At 11 and 12
// qubits (pauli_features_fused_q11_12.cu) a sample spans 2 and 4 warps, 32
// amplitudes a lane: an op on qubit 10 or 11 trades amplitudes with the
// partner warp through shared memory, the reduction adds the warps' shares
// there, and the phase runs derive C's columns from their members (C would
// take 176 and 384 KB: warp_program.cuh). Trig is
// warp_state.cuh's sin_cos (sincosf's algorithm, no fast-math intrinsics):
// features are held to the plain fused engine at 8e-6.
//
// Interface: plain C, loaded with ctypes. The launch returns
// cudaGetLastError(), which the Python wrapper checks.

#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_program.cuh"

namespace {

using namespace dqgp::warp;

template <int N>
__global__ void __launch_bounds__(kMaxThreads, FeaturesMinBlocks<N>::value)
warp_features_kernel(const float* __restrict__ angles,
                     const float* __restrict__ cperm,
                     const int* __restrict__ ops, const int* __restrict__ gates,
                     const int* __restrict__ members, float* __restrict__ out,
                     int B, int num_gates, int n_ops, int n_gates, int n_members,
                     int n_su2, int KT) {
  constexpr int kF = 3 * N;  // features a sample
  const ProgramArgs p{angles, cperm, ops, gates, members, B, num_gates,
                      n_ops, n_gates, n_members, n_su2, KT};
  // each lane of the sample writes its share of the features straight to
  // the output row (13 MB at config #7's step: no staging for them)
  run_fused_batch<N>(p, [out, B](const float (&re)[Geometry<N>::kA],
                                 const float (&im)[Geometry<N>::kA], int lig, int b) {
    reduce_features<N>(re, im, lig, out + (long long)b * kF, b < B);
  });
}

}  // namespace

// The qubit counts this translation unit instantiates: 1-10 here.
// pauli_features_fused_q11_12.cu includes this file with 11 and 12 (a sample
// across 2 and 4 warps), so that nvcc builds them beside this one, in parallel.
#ifndef DQGP_QUBITS
#define DQGP_QUBITS(X) X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8) X(9) X(10)
#endif

extern "C" {

// angles points at a (B, num_gates) float32 tensor, cperm at C permuted
// (KT, 2^n) as [column][register][lane of the group], ops at the (n_ops, 6),
// gates at the (n_gates, 2) and members at the (n_members,) int32 tables,
// out at (B, 3n) float32. Returns cudaGetLastError().
int dqgp_pauli_features_fused(const float* angles, const float* cperm,
                              const int* ops, const int* gates,
                              const int* members, float* out, int B, int n,
                              int num_gates, int n_ops, int n_gates,
                              int n_members, int n_su2, int KT, int tpb,
                              long long smem_bytes, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (n) {
#define DQGP_CASE(N)                                                            \
  case N:                                                                       \
    return launch_groups(warp_features_kernel<N>, Geometry<N>::kSamples,        \
                         Geometry<N>::kW, B, tpb, smem_bytes, s, angles, cperm, \
                         ops, gates, members, out, B, num_gates, n_ops,         \
                         n_gates, n_members, n_su2, KT);
    DQGP_QUBITS(DQGP_CASE)
#undef DQGP_CASE
  }
  return (int)cudaErrorInvalidValue;
}

// Resident blocks an SM holds of the n-qubit instantiation at this block
// size and shared memory (-1 on error).
int dqgp_pauli_features_fused_blocks_per_sm(int n, int tpb, long long smem_bytes) {
  switch (n) {
#define DQGP_CASE(N) \
  case N:            \
    return blocks_per_sm(warp_features_kernel<N>, tpb, smem_bytes);
    DQGP_QUBITS(DQGP_CASE)
#undef DQGP_CASE
  }
  return -1;
}

const char* dqgp_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
