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
// Design, float64 (states_kernel_f64): 2^n complex128 amplitudes over
// the same lanes would be 128 registers of state a lane at n >= 5, which
// does not fit, so the float64 kernel keeps the shared-memory layout
// of statevector.cuh's gate loop: one thread per sample, the state
// resident in shared memory as [amplitude][thread] planes at an odd stride,
// and after a barrier a cooperative store, consecutive threads taking
// consecutive amplitudes of one row. It runs once a dataset (B = 1000) and
// for float64 features.
//
// Interface: plain C, loaded with ctypes. The launches return
// cudaGetLastError(), which the Python wrapper checks.

#include <cuda_runtime.h>
#include <stdint.h>

#include "statevector.cuh"
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

// float64: one thread per sample, the state in shared memory.
__global__ void states_kernel_f64(const double* __restrict__ angles,
                                  const int* __restrict__ gates,
                                  double* __restrict__ out,
                                  int B, int G, int n, int gstride, int sstride) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tpb = blockDim.x;
  const int tid = threadIdx.x;
  const int dim = 1 << n;
  double* re = reinterpret_cast<double*>(smem_raw);  // [dim][sstride]
  double* im = re + (size_t)dim * sstride;            // [dim][sstride]
  double* ang = im + (size_t)dim * sstride;           // [tpb][gstride]

  const long long b0 = (long long)blockIdx.x * tpb;
  const int rows = (int)min((long long)tpb, (long long)B - b0);

  dqgp::stage_rows(ang, angles + b0 * G, rows, G, gstride);
  __syncthreads();
  if (tid < rows) {
    dqgp::init_zero_state(re + tid, im + tid, sstride, dim);
    dqgp::apply_gates(re + tid, im + tid, sstride, ang + tid * gstride, gates,
                      G, n);
  }
  __syncthreads();
  dqgp::store_states(reinterpret_cast<double2*>(out) + b0 * dim, re, im,
                     sstride, rows, n);
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

// gates is the (G, 3) int32 table [kind, qubit, control], out points at a
// (B, 2^n) complex128 tensor. Returns cudaGetLastError().
int dqgp_states_f64(const double* angles, const int* gates, double* out,
                    int B, int G, int n, int tpb, int gstride, int sstride,
                    long long smem_bytes, void* stream) {
  if (smem_bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        states_kernel_f64, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (B + tpb - 1) / tpb;
  states_kernel_f64<<<blocks, tpb, (size_t)smem_bytes, (cudaStream_t)stream>>>(
      angles, gates, out, B, G, n, gstride, sstride);
  return (int)cudaGetLastError();
}

const char* dqgp_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
