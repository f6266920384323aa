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
// kernel is templated on n (1..10), so every register index is a
// compile-time constant; up to 4 qubits it is held to 64 registers a thread
// (GateFeaturesMinBlocks: 32 resident warps an SM), which takes the
// north-star step's 2,633 warps in one round, in 128-thread blocks so that
// they spread evenly over the SMs (ops/cuda_circuit.py::features_geometry).
// ptxas reports no stack frame and no spills for any of the ten
// (chip_smoke.py's phase 2 fails otherwise). Trig is warp_state.cuh's
// sin_cos (sincosf's algorithm, no fast-math intrinsics): features are held
// to the plain PyTorch engine at 5e-6.
//
// Design, float64 (pauli_features_kernel_f64): 2^n complex128 amplitudes
// over the same lanes would be 128 registers of state a lane at n >= 5,
// which does not fit, so the float64 kernel keeps the shared-memory layout
// of statevector.cuh's gate loop: one thread per sample, the state resident
// in shared memory as [amplitude][thread] planes, the block's angle rows
// staged with coalesced loads at an odd stride, no barrier inside the gate
// loop. Trig is sincos; features are held to the plain engine at 1e-12. It
// runs for float64 features only (reference-grade checks).
//
// Interface: plain C, loaded with ctypes. The launches return
// cudaGetLastError(), which the Python wrapper checks.

#include <cuda_runtime.h>
#include <stdint.h>

#include "statevector.cuh"
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

// float64: one thread per sample, the state in shared memory.
__global__ void pauli_features_kernel_f64(const double* __restrict__ angles,
                                          const int* __restrict__ gates,
                                          double* __restrict__ out,
                                          int B, int G, int n, int gstride) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tpb = blockDim.x;
  const int tid = threadIdx.x;
  const int dim = 1 << n;
  double* re = reinterpret_cast<double*>(smem_raw);  // [dim][tpb]
  double* im = re + (size_t)dim * tpb;                // [dim][tpb]
  double* ang = im + (size_t)dim * tpb;               // [tpb][gstride]

  const long long b0 = (long long)blockIdx.x * tpb;
  const int rows = (int)min((long long)tpb, (long long)B - b0);

  dqgp::stage_rows(ang, angles + b0 * G, rows, G, gstride);
  dqgp::init_zero_state(re + tid, im + tid, tpb, dim);
  __syncthreads();
  if (tid >= rows) return;

  dqgp::apply_gates(re + tid, im + tid, tpb, ang + tid * gstride, gates, G, n);

  // <X_q> = 2 sum_{bit q = 0} Re(conj(s0) s1), <Y_q> = 2 sum Im(conj(s0) s1),
  // <Z_q> = sum (1 - 2 bit_q) |s|^2.
  const int half_dim = dim >> 1;
  double* o = out + (b0 + tid) * 3 * n;
  for (int q = 0; q < n; ++q) {
    const int lo = (1 << q) - 1;
    double x = 0.0, y = 0.0, z = 0.0;
    for (int p = 0; p < half_dim; ++p) {
      const int k0 = ((p >> q) << (q + 1)) | (p & lo);
      const int k1 = k0 | (1 << q);
      const double r0 = re[k0 * tpb + tid], i0 = im[k0 * tpb + tid];
      const double r1 = re[k1 * tpb + tid], i1 = im[k1 * tpb + tid];
      x += r0 * r1 + i0 * i1;
      y += r0 * i1 - i0 * r1;
      z += (r0 * r0 + i0 * i0) - (r1 * r1 + i1 * i1);
    }
    o[q] = 2.0 * x;
    o[n + q] = 2.0 * y;
    o[2 * n + q] = z;
  }
}

}  // namespace

#define DQGP_FOR_EACH_N(X) \
  X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8) X(9) X(10)

extern "C" {

// angles points at a (B, G) float32 tensor, gates at the (G, 3) int32 table
// [kind, qubit, control], out at a (B, 3n) float32 tensor. Returns
// cudaGetLastError().
int dqgp_pauli_features(const float* angles, const int* gates, float* out,
                        int B, int G, int n, int tpb, long long smem_bytes,
                        void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (n) {
#define DQGP_CASE(N)                                                       \
  case N:                                                                  \
    return launch_persistent(warp_pauli_features_kernel<N>,                \
                             Geometry<N>::kSamples, B, tpb, smem_bytes, s, \
                             angles, gates, out, B, G);
    DQGP_FOR_EACH_N(DQGP_CASE)
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
    DQGP_FOR_EACH_N(DQGP_CASE)
#undef DQGP_CASE
  }
  return -1;
}

// out points at a (B, 3n) float64 tensor. Returns cudaGetLastError().
int dqgp_pauli_features_f64(const double* angles, const int* gates,
                            double* out, int B, int G, int n, int tpb,
                            int gstride, long long smem_bytes, void* stream) {
  if (smem_bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        pauli_features_kernel_f64, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (B + tpb - 1) / tpb;
  pauli_features_kernel_f64<<<blocks, tpb, (size_t)smem_bytes,
                              (cudaStream_t)stream>>>(angles, gates, out, B, G,
                                                      n, gstride);
  return (int)cudaGetLastError();
}

const char* dqgp_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
