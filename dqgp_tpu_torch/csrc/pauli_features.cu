// Pauli-feature kernel (K1) for Hopper (sm_90a).
//
// Replaces dqgp_tpu/ops/pallas_circuit.py::make_pallas_pauli_features_fn:
// per sample, run the encoding circuit's gate sequence on |0...0> and reduce
// each qubit q to <X_q>, <Y_q>, <Z_q>. angles (B, G) -> features (B, 3n),
// laid out [X_0..X_{n-1} | Y_0.. | Z_0..], in float32 (the production path,
// like the Pallas kernel) or float64 (the reference-grade path that the JAX
// package runs through its complex128 XLA engine).
//
// What bounds it on this card: trig and shared-memory traffic per gate, not
// device memory. At 4 qubits a sample reads a 160 B angle row and writes a
// 48 B feature row, while its 40 gates each read and write 16 complex
// amplitudes and take one sincosf.
//
// Design: the state never leaves shared memory for the whole gate sequence.
// One thread owns one sample. A block's states are laid out [amplitude]
// [thread], so at each step the threads of a warp touch 32 consecutive words
// (no bank conflicts) and no thread waits on another: there is no barrier
// inside the gate loop (statevector.cuh). The block's angle rows are staged
// into shared memory with coalesced loads, each row padded to an odd stride
// so that the per-thread reads do not conflict either. The gate table (kind,
// qubit, control) is a small int32 device array that every thread reads at
// the same address. Trig uses sincosf / sincos (no fast-math intrinsics):
// float32 features are held to the plain PyTorch engine at 5e-6, float64
// ones at 1e-12.
//
// Interface: plain C, loaded with ctypes. The launch returns
// cudaGetLastError(), which the Python wrapper checks.

#include <cuda_runtime.h>
#include <stdint.h>

#include "statevector.cuh"

namespace {

template <typename T>
__global__ void pauli_features_kernel(const T* __restrict__ angles,
                                      const int* __restrict__ gates,
                                      T* __restrict__ out,
                                      int B, int G, int n, int gstride) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tpb = blockDim.x;
  const int tid = threadIdx.x;
  const int dim = 1 << n;
  T* re = reinterpret_cast<T*>(smem_raw);  // [dim][tpb]
  T* im = re + (size_t)dim * tpb;          // [dim][tpb]
  T* ang = im + (size_t)dim * tpb;         // [tpb][gstride]

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
  T* o = out + (b0 + tid) * 3 * n;
  for (int q = 0; q < n; ++q) {
    const int lo = (1 << q) - 1;
    T x = T(0), y = T(0), z = T(0);
    for (int p = 0; p < half_dim; ++p) {
      const int k0 = ((p >> q) << (q + 1)) | (p & lo);
      const int k1 = k0 | (1 << q);
      const T r0 = re[k0 * tpb + tid], i0 = im[k0 * tpb + tid];
      const T r1 = re[k1 * tpb + tid], i1 = im[k1 * tpb + tid];
      x += r0 * r1 + i0 * i1;
      y += r0 * i1 - i0 * r1;
      z += (r0 * r0 + i0 * i0) - (r1 * r1 + i1 * i1);
    }
    o[q] = T(2) * x;
    o[n + q] = T(2) * y;
    o[2 * n + q] = z;
  }
}

template <typename T>
int launch(const T* angles, const int* gates, T* out, int B, int G, int n,
           int tpb, int gstride, long long smem_bytes, void* stream) {
  if (smem_bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        pauli_features_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (B + tpb - 1) / tpb;
  pauli_features_kernel<T><<<blocks, tpb, (size_t)smem_bytes,
                             (cudaStream_t)stream>>>(angles, gates, out, B, G,
                                                     n, gstride);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch on `stream`; returns cudaGetLastError() (0 = success).
int dqgp_pauli_features(const float* angles, const int* gates, float* out,
                        int B, int G, int n, int tpb, int gstride,
                        long long smem_bytes, void* stream) {
  return launch<float>(angles, gates, out, B, G, n, tpb, gstride, smem_bytes,
                       stream);
}

int dqgp_pauli_features_f64(const double* angles, const int* gates,
                            double* out, int B, int G, int n, int tpb,
                            int gstride, long long smem_bytes, void* stream) {
  return launch<double>(angles, gates, out, B, G, n, tpb, gstride, smem_bytes,
                        stream);
}

const char* dqgp_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
