// Fused-program Pauli-feature kernel (K3) for Hopper (sm_90a).
//
// Replaces dqgp_tpu/ops/pallas_circuit.py::make_pallas_pauli_features_fused_fn:
// per sample, run the gate-fused op program of dqgp_tpu_torch/ops/fusion.py
// on |0...0> (the op loop of fused_program.cuh, shared with K4) and reduce
// each qubit q to <X_q>, <Y_q>, <Z_q>. Packed rows, transposed to (R, B)
// float32, -> features (B, 3n) float32 laid out [X_0..X_{n-1} | Y_0.. |
// Z_0..], as K1 lays them out. float32 only, as the Pallas kernel is.
//
// What bounds it on this card: shared memory. At 10 qubits a sample's state
// is 8 KB of re/im planes, so a block holds about two dozen samples and an
// SM runs one block: under one warp per SM, with little latency to hide
// behind. Per sample the work is one pass over the state per op (a 2x2
// product per amplitude pair, or a K-term phase and one sincosf per
// amplitude), then the reduction; device-memory traffic is one packed row
// in and 3n floats out.
//
// Design: one thread per sample, its state resident in shared memory as
// [amplitude][thread] planes (the threads of a warp touch consecutive words;
// no thread waits on another, and the kernel has no barrier). Unlike K4,
// nothing else lives in shared memory, so every byte of it goes to states:
//   * the packed rows come from device memory, transposed by the wrapper to
//     (R, B) so that the threads of a warp read consecutive words;
//   * the pattern matrix C (2^n, KT) and the op table are read from device
//     memory at one address by every thread at a time, so the reads
//     broadcast and stay in L1.
// The feature state never leaves the SM. Trig is sincosf (no fast-math
// intrinsics): features are held to the plain fused engine at 8e-6.
//
// Interface: plain C, loaded with ctypes. The launch returns
// cudaGetLastError(), which the Python wrapper checks.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fused_program.cuh"
#include "statevector.cuh"

namespace {

__global__ void pauli_features_fused_kernel(const float* __restrict__ packed_t,
                                            const float* __restrict__ cmat,
                                            const int* __restrict__ ops,
                                            float* __restrict__ out, int B,
                                            int n, int n_ops, int KT) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tpb = blockDim.x;
  const int tid = threadIdx.x;
  const int dim = 1 << n;
  float* re = reinterpret_cast<float*>(smem_raw);  // [dim][tpb]
  float* im = re + (size_t)dim * tpb;              // [dim][tpb]

  const long long b = (long long)blockIdx.x * tpb + tid;
  if (b >= B) return;
  float* st_re = re + tid;
  float* st_im = im + tid;
  dqgp::init_zero_state(st_re, st_im, tpb, dim);
  dqgp::run_fused_program(st_re, st_im, tpb, packed_t + b, (long long)B, cmat,
                          KT, ops, n_ops, n);

  // <X_q> = 2 sum_{bit q = 0} Re(conj(s0) s1), <Y_q> = 2 sum Im(conj(s0) s1),
  // <Z_q> = sum (1 - 2 bit_q) |s|^2, as K1 reduces them.
  const int half_dim = dim >> 1;
  float* o = out + b * 3 * n;
  for (int q = 0; q < n; ++q) {
    const int lo = (1 << q) - 1;
    float x = 0.f, y = 0.f, z = 0.f;
    for (int p = 0; p < half_dim; ++p) {
      const int k0 = ((p >> q) << (q + 1)) | (p & lo);
      const int k1 = k0 | (1 << q);
      const float r0 = st_re[k0 * tpb], i0 = st_im[k0 * tpb];
      const float r1 = st_re[k1 * tpb], i1 = st_im[k1 * tpb];
      x += r0 * r1 + i0 * i1;
      y += r0 * i1 - i0 * r1;
      z += (r0 * r0 + i0 * i0) - (r1 * r1 + i1 * i1);
    }
    o[q] = 2.f * x;
    o[n + q] = 2.f * y;
    o[2 * n + q] = z;
  }
}

}  // namespace

extern "C" {

// packed_t points at a (R, B) float32 tensor, out at (B, 3n) float32.
// Returns cudaGetLastError().
int dqgp_pauli_features_fused(const float* packed_t, const float* cmat,
                              const int* ops, float* out, int B, int n,
                              int n_ops, int KT, int tpb, long long smem_bytes,
                              void* stream) {
  if (smem_bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        pauli_features_fused_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (B + tpb - 1) / tpb;
  pauli_features_fused_kernel<<<blocks, tpb, (size_t)smem_bytes,
                                (cudaStream_t)stream>>>(packed_t, cmat, ops,
                                                        out, B, n, n_ops, KT);
  return (int)cudaGetLastError();
}

const char* dqgp_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
