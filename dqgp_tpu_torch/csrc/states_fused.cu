// Fused-program states kernel (K4) for Hopper (sm_90a).
//
// Replaces dqgp_tpu/ops/pallas_circuit.py::make_pallas_states_fused_fn: per
// sample, run the gate-fused op program of dqgp_tpu_torch/ops/fusion.py on
// |0...0> and write the final state out. packed rows (B, R) float32 ->
// states (B, 2^n) interleaved complex64. float32 only, as the Pallas kernel
// is. The program's ops (SU2, PERM, DIAG) and the op loop that runs them are
// in fused_program.cuh.
//
// All trig of the SU2 ops ran outside the kernel (fusion.packed_inputs), so
// the per-sample cost is one pass over the state per op plus one sincosf
// per amplitude per DIAG op.
//
// What bounds it on this card: shared-memory traffic per op and, at large
// n, the store of the states; device-memory reads are one packed row per
// sample.
//
// Design: K2's (states.cu): one thread per sample, the state resident in
// shared memory as [amplitude][thread] planes with a padded odd stride, the
// block's packed rows staged with coalesced loads at an odd row stride, and
// a cooperative, coalesced store of the block's tile at the end. The op
// table (6 int32 per op) is read by every thread at the same address. The
// static phase-pattern matrix C (2^n, KT) float32 is staged into shared
// memory once per block; every thread reads the same entry at the same
// time, so the reads broadcast.
//
// Interface: plain C, loaded with ctypes. The launch returns
// cudaGetLastError(), which the Python wrapper checks.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fused_program.cuh"
#include "statevector.cuh"

namespace {

__global__ void states_fused_kernel(const float* __restrict__ packed,
                                    const float* __restrict__ cmat,
                                    const int* __restrict__ ops,
                                    float* __restrict__ out, int B, int R,
                                    int n, int n_ops, int KT, int rstride,
                                    int sstride) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tpb = blockDim.x;
  const int tid = threadIdx.x;
  const int dim = 1 << n;
  float* re = reinterpret_cast<float*>(smem_raw);  // [dim][sstride]
  float* im = re + (size_t)dim * sstride;          // [dim][sstride]
  float* rows_s = im + (size_t)dim * sstride;      // [tpb][rstride]
  float* c_s = rows_s + (size_t)tpb * rstride;     // [dim][KT]

  const long long b0 = (long long)blockIdx.x * tpb;
  const int rows = (int)min((long long)tpb, (long long)B - b0);

  dqgp::stage_rows(rows_s, packed + b0 * R, rows, R, rstride);
  for (int i = tid; i < dim * KT; i += tpb) c_s[i] = cmat[i];
  __syncthreads();
  if (tid < rows) {
    float* st_re = re + tid;
    float* st_im = im + tid;
    const float* p = rows_s + tid * rstride;
    dqgp::init_zero_state(st_re, st_im, sstride, dim);
    dqgp::run_fused_program(st_re, st_im, sstride, p, 1, c_s, KT, ops, n_ops, n);
  }
  __syncthreads();
  dqgp::store_states<float>(reinterpret_cast<float2*>(out) + b0 * dim, re, im,
                            sstride, rows, n);
}

}  // namespace

extern "C" {

// out points at a (B, 2^n) complex64 tensor. Returns cudaGetLastError().
int dqgp_states_fused(const float* packed, const float* cmat, const int* ops,
                      float* out, int B, int R, int n, int n_ops, int KT,
                      int tpb, int rstride, int sstride, long long smem_bytes,
                      void* stream) {
  if (smem_bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        states_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (B + tpb - 1) / tpb;
  states_fused_kernel<<<blocks, tpb, (size_t)smem_bytes,
                        (cudaStream_t)stream>>>(packed, cmat, ops, out, B, R, n,
                                                n_ops, KT, rstride, sstride);
  return (int)cudaGetLastError();
}

const char* dqgp_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
