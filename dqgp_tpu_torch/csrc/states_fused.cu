// Fused-program states kernel (K4) for Hopper (sm_90a).
//
// Replaces dqgp_tpu/ops/pallas_circuit.py::make_pallas_states_fused_fn: per
// sample, run the gate-fused op program of dqgp_tpu_torch/ops/fusion.py on
// |0...0> and write the final state out. packed rows (B, R) float32 ->
// states (B, 2^n) interleaved complex64. float32 only, as the Pallas kernel
// is. The program's ops, as the Pallas kernel's _apply_fused_ref runs them:
//
//   SU2   a fused 2x2 unitary on qubit q, optionally controlled: its 8
//         coefficients (u00re, u00im, u01re, u01im, u10re, u10im, u11re,
//         u11im) are packed rows [row, row + 8); `real` and `diag` flags skip
//         the terms that are zero;
//   PERM  a CX permutation;
//   DIAG  a run of commuting diagonal gates: phi = C[:, col:col+K] . rows
//         [row, row + K), then state *= cos(phi) + i sin(phi).
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

#include "statevector.cuh"

namespace {

// Op table: 6 int32 per op, [type, qubit, control, row, k_or_col, flags].
//   SU2:  row = 8 * slot, flags bit 0 = real, bit 1 = diag
//   PERM: qubit (target), control
//   DIAG: row = first angle row, k_or_col = K, control = column of C
enum { OP_SU2 = 0, OP_PERM = 1, OP_DIAG = 2 };
enum { FLAG_REAL = 1, FLAG_DIAG = 2 };
constexpr int kOpWords = 6;

__device__ void apply_su2(float* re, float* im, int stride, const float* u,
                          int q, int ctl, int flags, int n) {
  const int half_dim = 1 << (n - 1);
  const int lo = (1 << q) - 1;
  const float a0r = u[0], a0i = u[1], b0r = u[2], b0i = u[3];  // u00, u01
  const float b1r = u[4], b1i = u[5], a1r = u[6], a1i = u[7];  // u10, u11
  for (int p = 0; p < half_dim; ++p) {
    const int k0 = ((p >> q) << (q + 1)) | (p & lo);
    const int k1 = k0 | (1 << q);
    if (ctl >= 0 && !((k0 >> ctl) & 1)) continue;  // control bit clear
    float* pr0 = re + k0 * stride;
    float* pi0 = im + k0 * stride;
    float* pr1 = re + k1 * stride;
    float* pi1 = im + k1 * stride;
    const float r0 = *pr0, i0 = *pi0, r1 = *pr1, i1 = *pi1;
    if (flags & FLAG_DIAG) {  // diag(u00, u11)
      *pr0 = a0r * r0 - a0i * i0;  *pi0 = a0r * i0 + a0i * r0;
      *pr1 = a1r * r1 - a1i * i1;  *pi1 = a1r * i1 + a1i * r1;
    } else if (flags & FLAG_REAL) {  // all four entries real
      *pr0 = a0r * r0 + b0r * r1;  *pi0 = a0r * i0 + b0r * i1;
      *pr1 = a1r * r1 + b1r * r0;  *pi1 = a1r * i1 + b1r * i0;
    } else {  // s0' = u00 s0 + u01 s1, s1' = u11 s1 + u10 s0
      *pr0 = a0r * r0 - a0i * i0 + b0r * r1 - b0i * i1;
      *pi0 = a0r * i0 + a0i * r0 + b0r * i1 + b0i * r1;
      *pr1 = a1r * r1 - a1i * i1 + b1r * r0 - b1i * i0;
      *pi1 = a1r * i1 + a1i * r1 + b1r * i0 + b1i * r0;
    }
  }
}

__device__ void apply_perm(float* re, float* im, int stride, int q, int ctl,
                           int n) {
  const int half_dim = 1 << (n - 1);
  const int lo = (1 << q) - 1;
  for (int p = 0; p < half_dim; ++p) {
    const int k0 = ((p >> q) << (q + 1)) | (p & lo);
    if (!((k0 >> ctl) & 1)) continue;
    const int k1 = k0 | (1 << q);
    float* pr0 = re + k0 * stride;
    float* pi0 = im + k0 * stride;
    float* pr1 = re + k1 * stride;
    float* pi1 = im + k1 * stride;
    const float r0 = *pr0, i0 = *pi0;
    *pr0 = *pr1;  *pi0 = *pi1;  *pr1 = r0;  *pi1 = i0;
  }
}

__device__ void apply_diag(float* re, float* im, int stride, const float* a,
                           const float* cmat, int KT, int col, int K, int n) {
  const int dim = 1 << n;
  for (int k = 0; k < dim; ++k) {
    const float* crow = cmat + k * KT + col;
    float phi = crow[0] * a[0];
    for (int j = 1; j < K; ++j) phi += crow[j] * a[j];
    float s, c;
    sincosf(phi, &s, &c);
    float* pr = re + k * stride;
    float* pi = im + k * stride;
    const float r0 = *pr, i0 = *pi;
    *pr = c * r0 - s * i0;
    *pi = c * i0 + s * r0;
  }
}

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
    for (int o = 0; o < n_ops; ++o) {
      const int* op = ops + kOpWords * o;
      const int type = __ldg(op), q = __ldg(op + 1), ctl = __ldg(op + 2);
      const int row = __ldg(op + 3), kc = __ldg(op + 4), flags = __ldg(op + 5);
      if (type == OP_SU2) {
        apply_su2(st_re, st_im, sstride, p + row, q, ctl, flags, n);
      } else if (type == OP_PERM) {
        apply_perm(st_re, st_im, sstride, q, ctl, n);
      } else {
        apply_diag(st_re, st_im, sstride, p + row, c_s, KT, ctl, kc, n);
      }
    }
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
