// Fused-program states kernel (K4) for Hopper (sm_90a).
//
// Replaces dqgp_tpu/ops/pallas_circuit.py::make_pallas_states_fused_fn: per
// sample, run the gate-fused op program of dqgp_tpu_torch/ops/fusion.py on
// |0...0> and write the final state out. Angles (B, G) float32 -> states
// (B, 2^n) interleaved complex64. float32 only, as the Pallas kernel is. Like
// the TPU function, which builds its packed coefficient rows from the angles
// inside the same call, the kernel takes the angles and forms each SU2 op's
// fused 2x2 itself.
//
// What bounds it on this card: the store of the states. A sample writes
// 8 * 2^n bytes against 4 G read; at the fidelity path's 6 qubits that is
// 512 B against 92 B, and the 11 fused ops cost ~1.4e3 operations a sample.
//
// Design: the fused program's body is warp_program.cuh's, shared with the
// fused Pauli-feature kernel (K3): a sample's state in registers across a
// lane group (warp_state.cuh), tables, C and each warp's staged rows in
// shared memory, persistent blocks. This kernel adds the write-out, and for
// its sake its tables map the qubits onto the state's bits the other way
// round from K3's (ops/cuda_circuit.py::fused_tables): qubits 0..n-6 lie on
// the lane bits, n-5..n-1 on the register bits, so amplitude k is register
// k >> (n-5) of lane k & (L-1), and for each register the lanes of a sample
// hold L consecutive amplitudes. store_state writes them as float4s, two
// full 256 B lines a warp and instruction at 10 qubits, with no staging in
// shared memory and no state register kept beyond its store. The kernel is
// templated on n (1..10); ptxas reports no stack frame and no spills for any
// of the ten (chip_smoke.py's phase 2 fails otherwise).
//
// Interface: plain C, loaded with ctypes. The launch returns
// cudaGetLastError(), which the Python wrapper checks.

#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_program.cuh"

namespace {

using namespace dqgp::warp;

template <int N>
__global__ void __launch_bounds__(kMaxThreads, kStatesMinBlocks)
warp_states_fused_kernel(const float* __restrict__ angles,
                         const float* __restrict__ cperm,
                         const int* __restrict__ ops,
                         const int* __restrict__ gates,
                         const int* __restrict__ members,
                         float* __restrict__ out, int B, int num_gates,
                         int n_ops, int n_gates, int n_members, int n_su2,
                         int KT) {
  const ProgramArgs p{angles, cperm, ops, gates, members, B, num_gates,
                      n_ops, n_gates, n_members, n_su2, KT};
  run_fused_batch<N>(p, [out, B](const float (&re)[Geometry<N>::kA],
                                 const float (&im)[Geometry<N>::kA], int lig, int b) {
    store_state<N>(re, im, lig, out + (long long)b * (2 * Geometry<N>::kDim), b < B);
  });
}

}  // namespace

#define DQGP_FOR_EACH_N(X) \
  X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8) X(9) X(10)

extern "C" {

// angles points at a (B, num_gates) float32 tensor, cperm at C permuted
// (KT, 2^n) as [column][register][lane of the group], ops at the (n_ops, 6),
// gates at the (n_gates, 2) and members at the (n_members,) int32 tables
// (qubits as the states kernels' physical bits), out at a (B, 2^n) complex64
// tensor. Returns cudaGetLastError().
int dqgp_states_fused(const float* angles, const float* cperm, const int* ops,
                      const int* gates, const int* members, float* out, int B,
                      int n, int num_gates, int n_ops, int n_gates,
                      int n_members, int n_su2, int KT, int tpb,
                      long long smem_bytes, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (n) {
#define DQGP_CASE(N)                                                         \
  case N:                                                                    \
    return launch_persistent(warp_states_fused_kernel<N>,                    \
                             Geometry<N>::kSamples, B, tpb, smem_bytes, s,   \
                             angles, cperm, ops, gates, members, out, B,     \
                             num_gates, n_ops, n_gates, n_members, n_su2, KT);
    DQGP_FOR_EACH_N(DQGP_CASE)
#undef DQGP_CASE
  }
  return (int)cudaErrorInvalidValue;
}

// Resident blocks an SM holds of the n-qubit instantiation at this block
// size and shared memory (-1 on error).
int dqgp_states_fused_blocks_per_sm(int n, int tpb, long long smem_bytes) {
  switch (n) {
#define DQGP_CASE(N) \
  case N:            \
    return blocks_per_sm(warp_states_fused_kernel<N>, tpb, smem_bytes);
    DQGP_FOR_EACH_N(DQGP_CASE)
#undef DQGP_CASE
  }
  return -1;
}

const char* dqgp_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
