// States kernel (K2) for Hopper (sm_90a).
//
// Replaces dqgp_tpu/ops/pallas_circuit.py::make_pallas_states_fn: per
// sample, run the encoding circuit's gate sequence on |0...0> and write the
// final state out. angles (B, G) -> states (B, 2^n) interleaved complex, in
// complex64 from float32 angles (the production path, like the Pallas
// kernel) or complex128 from float64 angles (the reference-grade path: the
// float64 dataset Gram and float64 features, which the JAX package runs in
// complex128 on CPU and GPU).
//
// What bounds it on this card: the store of the states. At the fidelity
// path's 6 qubits a sample reads a 92 B angle row and writes 512 B of
// complex64 state, and its 23 gates cost ~6e3 operations.
//
// Design, float32 (warp_states_kernel): a sample's state lives in registers
// across a lane group (warp_state.cuh: 32 complex amplitudes a lane, a whole
// warp a sample at 10 qubits, a lane a sample at n <= 5), and the kernel
// applies the circuit's gates one at a time, in the circuit's order, through
// apply_gate (run_gate_batch, the batch loop it shares with K1): it stays
// the unfused sequence, the independent check of the fused program (K4).
// Shared memory holds the gate table and each warp's staged angle rows
// (loaded coalesced, at an odd stride); no state. The
// gate table gives qubits as physical bits under the states kernels' map
// (ops/cuda_circuit.py::states_bit): qubits 0..n-6 on the lane bits, n-5..n-1
// on the register bits, so that for each register the lanes of a sample
// hold consecutive amplitudes and store_state writes them as float4s, two
// full 256 B lines a warp and instruction at 10 qubits. Blocks are
// persistent: each loads the gate table once, then its warps walk the batch
// a warp-sized group of samples at a time. Templated on n (1..10); ptxas
// reports no stack frame and no spills for any of the ten (chip_smoke.py's
// phase 2 fails otherwise). Trig is warp_state.cuh's sin_cos.
//
// Design, float64 (warp_states_f64_kernel): the float32 design in
// complex128, through the same batch loop and gate bodies (warp_state.cuh,
// templated on the real type), geometry and bit map; a lane's state is 4 x
// 2^n registers, so two blocks an SM up to 4 qubits and one (up to 255
// registers a thread) from 5 up (F64MinBlocks). The write-out keeps the
// stores coalesced (store_state_f64): at 10 qubits a warp's sample writes
// 512 B a store from its registers; below, the warp's samples' rows are one
// run of the output, which goes through the warp's buffer in shared memory
// and out 512 B a store. Trig is warp_state.cuh's float64 sin_cos. It runs
// once a dataset (B = 1000), for float64 features and in the condition-
// number backfill of the fidelity kernel. Its first layout (one thread a
// sample, the state in shared memory) stays in circuit_f64_first_layout.cu
// for chip_smoke.py's timing only.
//
// Interface: plain C, loaded with ctypes. The launches return
// cudaGetLastError(), which the Python wrapper checks.

#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_state.cuh"

namespace {

using namespace dqgp::warp;

// float32: gates points at the (G, 3) int32 table [kind, bit, control bit],
// out at (B, 2^N) complex64. The batch loop is warp_state.cuh's
// run_gate_batch, shared with the Pauli-feature kernel (K1).
template <int N>
__global__ void __launch_bounds__(kMaxThreads, kStatesMinBlocks)
warp_states_kernel(const float* __restrict__ angles,
                   const int* __restrict__ gates, float* __restrict__ out,
                   int B, int G) {
  run_gate_batch<N>(angles, gates, B, G,
                    [out, B](const float (&re)[Geometry<N>::kA],
                             const float (&im)[Geometry<N>::kA], int lig, int b,
                             const Staged&) {
    store_state<N>(re, im, lig, out + (long long)b * (2 * Geometry<N>::kDim), b < B);
  });
}

// float64: the same in complex128, out at (B, 2^N) complex128. The launch
// adds each warp's staging buffer for the write-out (kSamples rows of
// kStateStageStride<N> complex128) after every warp's rows, below 10 qubits.
template <int N>
__global__ void __launch_bounds__(kMaxThreads, F64MinBlocks<N>::value)
warp_states_f64_kernel(const double* __restrict__ angles,
                       const int* __restrict__ gates, double* __restrict__ out,
                       int B, int G) {
  using Geo = Geometry<N, double>;
  run_gate_batch<N>(angles, gates, B, G,
                    [out, B](const double (&re)[Geo::kA], const double (&im)[Geo::kA],
                             int lig, int b, const StagedT<double>& st) {
    const int sw = (threadIdx.x & 31) / Geo::kL;
    double2* buf = reinterpret_cast<double2*>(st.scratch) +
                   (threadIdx.x >> 5) * Geo::kSamples * kStateStageStride<N>;
    store_state_f64<N>(re, im, lig, sw, reinterpret_cast<double2*>(out), b - sw, B, buf);
  });
}

}  // namespace

#define DQGP_FOR_EACH_N(X) \
  X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8) X(9) X(10)

extern "C" {

// angles points at a (B, G) float32 tensor, gates at the (G, 3) int32 table
// [kind, bit, control bit] under the states kernels' bit map, out at a
// (B, 2^n) complex64 tensor. Returns cudaGetLastError().
int dqgp_states(const float* angles, const int* gates, float* out, int B,
                int G, int n, int tpb, long long smem_bytes, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (n) {
#define DQGP_CASE(N)                                                        \
  case N:                                                                   \
    return launch_persistent(warp_states_kernel<N>, Geometry<N>::kSamples, \
                             B, tpb, smem_bytes, s, angles, gates, out, B, G);
    DQGP_FOR_EACH_N(DQGP_CASE)
#undef DQGP_CASE
  }
  return (int)cudaErrorInvalidValue;
}

// Resident blocks an SM holds of the n-qubit float32 instantiation at this
// block size and shared memory (-1 on error).
int dqgp_states_blocks_per_sm(int n, int tpb, long long smem_bytes) {
  switch (n) {
#define DQGP_CASE(N) \
  case N:            \
    return blocks_per_sm(warp_states_kernel<N>, tpb, smem_bytes);
    DQGP_FOR_EACH_N(DQGP_CASE)
#undef DQGP_CASE
  }
  return -1;
}

// The float64 instantiations: angles (B, G) float64, the gate table under
// the states kernels' bit map, out (B, 2^n) complex128. Returns
// cudaGetLastError().
int dqgp_states_f64(const double* angles, const int* gates, double* out, int B,
                    int G, int n, int tpb, long long smem_bytes, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (n) {
#define DQGP_CASE(N)                                                                     \
  case N:                                                                                \
    return launch_persistent(warp_states_f64_kernel<N>, Geometry<N, double>::kSamples, \
                             B, tpb, smem_bytes, s, angles, gates, out, B, G);
    DQGP_FOR_EACH_N(DQGP_CASE)
#undef DQGP_CASE
  }
  return (int)cudaErrorInvalidValue;
}

int dqgp_states_f64_blocks_per_sm(int n, int tpb, long long smem_bytes) {
  switch (n) {
#define DQGP_CASE(N) \
  case N:            \
    return blocks_per_sm(warp_states_f64_kernel<N>, tpb, smem_bytes);
    DQGP_FOR_EACH_N(DQGP_CASE)
#undef DQGP_CASE
  }
  return -1;
}

const char* dqgp_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
