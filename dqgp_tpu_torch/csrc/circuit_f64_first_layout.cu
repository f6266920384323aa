// The first layout of the float64 instantiations of the Pauli-feature
// kernel (K1) and of the states kernel (K2): one thread a sample, the state
// in shared memory (statevector.cuh). Kept beside their redesign
// (pauli_features.cu and states.cu, the state in registers across a lane
// group) so that chip_smoke.py can time the two in turns in one call. The
// package does not launch them.
//
// Design: one thread runs one sample's gate sequence on a state resident in
// shared memory as [amplitude][thread] planes (statevector.cuh's gate
// loop), the block's angle rows staged with coalesced loads at an odd
// stride, no barrier inside the gate loop. K1 then reduces each qubit to
// <X>, <Y>, <Z>; K2, after a barrier, stores the block's states
// cooperatively, consecutive threads taking consecutive amplitudes of one
// row, from planes at an odd stride. Threads per block halve from 128 until
// the states fit the shared-memory budget (ops/cuda_circuit.py's
// launch_config and states_launch_config): 8 at 10 qubits. Trig is sincos.
//
// Interface: plain C, loaded with ctypes. The launches return
// cudaGetLastError().

#include <cuda_runtime.h>

#include "statevector.cuh"

namespace {

// K1: out at (B, 3n) float64.
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

// K2: out at (B, 2^n) complex128.
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

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, long long smem_bytes) {
  if (smem_bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem_bytes);
}

}  // namespace

extern "C" {

// angles points at a (B, G) float64 tensor, gates at the (G, 3) int32 table
// [kind, qubit, control] (qubit q on bit q), out at a (B, 3n) float64
// tensor. Returns cudaGetLastError().
int dqgp_pauli_features_f64_first_layout(const double* angles, const int* gates,
                                         double* out, int B, int G, int n, int tpb,
                                         int gstride, long long smem_bytes,
                                         void* stream) {
  const cudaError_t e = allow_smem(pauli_features_kernel_f64, smem_bytes);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (B + tpb - 1) / tpb;
  pauli_features_kernel_f64<<<blocks, tpb, (size_t)smem_bytes,
                              (cudaStream_t)stream>>>(angles, gates, out, B, G,
                                                      n, gstride);
  return (int)cudaGetLastError();
}

// The same gate table (qubit q on bit q), out at a (B, 2^n) complex128
// tensor. Returns cudaGetLastError().
int dqgp_states_f64_first_layout(const double* angles, const int* gates, double* out,
                                 int B, int G, int n, int tpb, int gstride,
                                 int sstride, long long smem_bytes, void* stream) {
  const cudaError_t e = allow_smem(states_kernel_f64, smem_bytes);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (B + tpb - 1) / tpb;
  states_kernel_f64<<<blocks, tpb, (size_t)smem_bytes, (cudaStream_t)stream>>>(
      angles, gates, out, B, G, n, gstride, sstride);
  return (int)cudaGetLastError();
}

}  // extern "C"
