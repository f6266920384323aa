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
// What bounds it on this card: the gate loop's trig and shared-memory
// traffic, and at large n the store of the states. At the fidelity path's
// 6 qubits a sample reads a 92 B angle row and writes 512 B of complex64
// state, while its 23 gates each read and write up to 64 amplitudes.
//
// Design: the gate loop is K1's (statevector.cuh): one thread per sample,
// the state resident in shared memory as [amplitude][thread] planes for the
// whole sequence. The planes' stride is padded to an odd number of words,
// so that the epilogue can read them across threads: after a barrier the
// block writes its tile out cooperatively, consecutive threads taking
// consecutive amplitudes of one row, so each warp's stores coalesce into
// one contiguous 256 B (float) or 512 B (double) segment, and its
// shared-memory reads (stride apart) fall in distinct banks.
//
// Interface: plain C, loaded with ctypes. The launch returns
// cudaGetLastError(), which the Python wrapper checks.

#include <cuda_runtime.h>
#include <stdint.h>

#include "statevector.cuh"

namespace {

template <typename T>
__global__ void states_kernel(const T* __restrict__ angles,
                              const int* __restrict__ gates,
                              T* __restrict__ out,
                              int B, int G, int n, int gstride, int sstride) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tpb = blockDim.x;
  const int tid = threadIdx.x;
  const int dim = 1 << n;
  T* re = reinterpret_cast<T*>(smem_raw);  // [dim][sstride]
  T* im = re + (size_t)dim * sstride;      // [dim][sstride]
  T* ang = im + (size_t)dim * sstride;     // [tpb][gstride]

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
  using C2 = typename dqgp::Complex2<T>::type;
  dqgp::store_states<T>(reinterpret_cast<C2*>(out) + b0 * dim, re, im,
                        sstride, rows, n);
}

template <typename T>
int launch(const T* angles, const int* gates, T* out, int B, int G, int n,
           int tpb, int gstride, int sstride, long long smem_bytes,
           void* stream) {
  if (smem_bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        states_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (B + tpb - 1) / tpb;
  states_kernel<T><<<blocks, tpb, (size_t)smem_bytes, (cudaStream_t)stream>>>(
      angles, gates, out, B, G, n, gstride, sstride);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// out points at a (B, 2^n) complex64 tensor. Returns cudaGetLastError().
int dqgp_states(const float* angles, const int* gates, float* out, int B,
                int G, int n, int tpb, int gstride, int sstride,
                long long smem_bytes, void* stream) {
  return launch<float>(angles, gates, out, B, G, n, tpb, gstride, sstride,
                       smem_bytes, stream);
}

// out points at a (B, 2^n) complex128 tensor. Returns cudaGetLastError().
int dqgp_states_f64(const double* angles, const int* gates, double* out,
                    int B, int G, int n, int tpb, int gstride, int sstride,
                    long long smem_bytes, void* stream) {
  return launch<double>(angles, gates, out, B, G, n, tpb, gstride, sstride,
                        smem_bytes, stream);
}

const char* dqgp_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
