// Fused-program op loop of the fused states kernel (K4, states_fused.cu).
// (The fused Pauli-feature kernel K3 runs the same ops on a state held in
// registers: warp_state.cuh.)
//
// One thread runs one sample's gate-fused op program (dqgp_tpu_torch/ops/
// fusion.py) on a state held as [amplitude][stride] planes: amplitude k of
// the thread's state lies at re[k * stride] and im[k * stride], where re and
// im already point at the thread's column. The program's ops, as the Pallas
// kernels' _apply_fused_ref runs them:
//
//   SU2   a fused 2x2 unitary on qubit q, optionally controlled: its 8
//         coefficients (u00re, u00im, u01re, u01im, u10re, u10im, u11re,
//         u11im) are packed rows [row, row + 8); `real` and `diag` flags skip
//         the terms that are zero;
//   PERM  a CX permutation;
//   DIAG  a run of commuting diagonal gates: phi = C[:, col:col+K] . rows
//         [row, row + K), then state *= cos(phi) + i sin(phi).
//
// The sample's packed row is read through a stride: entry j lies at
// p[j * pstride] (K4 stages rows in shared memory, pstride 1). The float32
// arithmetic is the one K4 ran before the loop moved here.

#pragma once

#include <cuda_runtime.h>

namespace dqgp {

// Op table: 6 int32 per op, [type, qubit, control, row, k_or_col, flags].
//   SU2:  row = 8 * slot, flags bit 0 = real, bit 1 = diag
//   PERM: qubit (target), control
//   DIAG: row = first angle row, k_or_col = K, control = column of C
enum { OP_SU2 = 0, OP_PERM = 1, OP_DIAG = 2 };
enum { FLAG_REAL = 1, FLAG_DIAG = 2 };
constexpr int kOpWords = 6;

__device__ __forceinline__ void apply_su2(float* re, float* im, int stride,
                                          const float* u, long long ustride,
                                          int q, int ctl, int flags, int n) {
  const int half_dim = 1 << (n - 1);
  const int lo = (1 << q) - 1;
  const float a0r = u[0], a0i = u[ustride];                    // u00
  const float b0r = u[2 * ustride], b0i = u[3 * ustride];      // u01
  const float b1r = u[4 * ustride], b1i = u[5 * ustride];      // u10
  const float a1r = u[6 * ustride], a1i = u[7 * ustride];      // u11
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

__device__ __forceinline__ void apply_perm(float* re, float* im, int stride,
                                           int q, int ctl, int n) {
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

__device__ __forceinline__ void apply_diag(float* re, float* im, int stride,
                                           const float* a, long long astride,
                                           const float* cmat, int KT, int col,
                                           int K, int n) {
  const int dim = 1 << n;
  for (int k = 0; k < dim; ++k) {
    const float* crow = cmat + k * KT + col;
    float phi = crow[0] * a[0];
    for (int j = 1; j < K; ++j) phi += crow[j] * a[j * astride];
    float s, c;
    sincosf(phi, &s, &c);
    float* pr = re + k * stride;
    float* pi = im + k * stride;
    const float r0 = *pr, i0 = *pi;
    *pr = c * r0 - s * i0;
    *pi = c * i0 + s * r0;
  }
}

// Run the whole program on this thread's state. `ops` is the (n_ops, 6)
// int32 table, read by every thread at the same address; `cmat` the (2^n,
// KT) pattern matrix, also read at one address by all threads at a time.
__device__ __forceinline__ void run_fused_program(
    float* re, float* im, int stride, const float* p, long long pstride,
    const float* cmat, int KT, const int* __restrict__ ops, int n_ops, int n) {
  for (int o = 0; o < n_ops; ++o) {
    const int* op = ops + kOpWords * o;
    const int type = __ldg(op), q = __ldg(op + 1), ctl = __ldg(op + 2);
    const int row = __ldg(op + 3), kc = __ldg(op + 4), flags = __ldg(op + 5);
    if (type == OP_SU2) {
      apply_su2(re, im, stride, p + row * pstride, pstride, q, ctl, flags, n);
    } else if (type == OP_PERM) {
      apply_perm(re, im, stride, q, ctl, n);
    } else {
      apply_diag(re, im, stride, p + row * pstride, pstride, cmat, KT, ctl,
                 kc, n);
    }
  }
}

}  // namespace dqgp
