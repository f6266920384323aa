// Float64 statevector gate loop of the first layout of K1's and K2's
// float64 kernels (circuit_f64_first_layout.cu), which chip_smoke.py times
// beside their redesign on the register layout (warp_state.cuh, templated
// on the real type); the package does not launch it.
//
// One thread runs one sample's gate sequence on a state held in shared
// memory as [amplitude][thread]: amplitude k of the thread's state lies at
// re[k * stride] and im[k * stride], where re and im already point at the
// thread's column. The threads of a warp then touch consecutive words at
// every step, and no thread waits on another inside the gate loop.

#pragma once

#include <cuda_runtime.h>

namespace dqgp {

// Gate kinds, as in dqgp_tpu_torch/ops/circuit.py.
enum { RX = 0, RY, RZ, H, CX, CZ, CRX, CRY, CRZ, RZZ };

constexpr double kSqrt1_2 = 0.7071067811865476;

// Copy `rows` rows of a row-major (rows, len) matrix into shared memory as
// [row][rstride], with coalesced loads by the whole block. An odd rstride
// keeps the per-thread row reads that follow free of bank conflicts.
__device__ __forceinline__ void stage_rows(double* dst, const double* __restrict__ src,
                                           int rows, int len, int rstride) {
  for (int i = threadIdx.x; i < rows * len; i += blockDim.x) {
    const int r = i / len;
    dst[r * rstride + (i - r * len)] = src[i];
  }
}

// |0...0> in this thread's column.
__device__ __forceinline__ void init_zero_state(double* re, double* im, int stride, int dim) {
  for (int k = 0; k < dim; ++k) {
    re[k * stride] = (k == 0) ? 1.0 : 0.0;
    im[k * stride] = 0.0;
  }
}

// Apply the circuit's G gates to this thread's state. `gates` is the (G, 3)
// int32 table [kind, qubit, control], read by every thread at the same
// address; `a_row` is this sample's G angles.
__device__ inline void apply_gates(double* re, double* im, int stride, const double* a_row,
                                   const int* __restrict__ gates, int G, int n) {
  const int dim = 1 << n;
  const int half_dim = dim >> 1;
  for (int g = 0; g < G; ++g) {
    const int kind = __ldg(gates + 3 * g);
    const int q = __ldg(gates + 3 * g + 1);
    const int ctl = __ldg(gates + 3 * g + 2);
    double c = 1.0, s = 0.0;
    if (kind != H && kind != CX && kind != CZ) sincos(0.5 * a_row[g], &s, &c);

    if (kind == CZ || kind == RZZ) {
      // Diagonal two-qubit gates: one pass over all amplitudes.
      for (int k = 0; k < dim; ++k) {
        const int bq = (k >> q) & 1, bc = (k >> ctl) & 1;
        double* pr = re + k * stride;
        double* pi = im + k * stride;
        if (kind == CZ) {
          if (bq & bc) { *pr = -*pr; *pi = -*pi; }
        } else {
          // exp(-i a/2 * sgn), sgn = +1 where the bits agree.
          const double sg = (bq == bc) ? s : -s;
          const double r0 = *pr, i0 = *pi;
          *pr = c * r0 + sg * i0;
          *pi = c * i0 - sg * r0;
        }
      }
      continue;
    }

    const int lo = (1 << q) - 1;
    for (int p = 0; p < half_dim; ++p) {
      const int k0 = ((p >> q) << (q + 1)) | (p & lo);
      const int k1 = k0 | (1 << q);
      if (ctl >= 0 && !((k0 >> ctl) & 1)) continue;  // control bit clear
      double* pr0 = re + k0 * stride;
      double* pi0 = im + k0 * stride;
      double* pr1 = re + k1 * stride;
      double* pi1 = im + k1 * stride;
      const double r0 = *pr0, i0 = *pi0, r1 = *pr1, i1 = *pi1;
      switch (kind) {
        case RX: case CRX:  // [[c, -is], [-is, c]]
          *pr0 = c * r0 + s * i1;  *pi0 = c * i0 - s * r1;
          *pr1 = c * r1 + s * i0;  *pi1 = c * i1 - s * r0;
          break;
        case RY: case CRY:  // [[c, -s], [s, c]]
          *pr0 = c * r0 - s * r1;  *pi0 = c * i0 - s * i1;
          *pr1 = s * r0 + c * r1;  *pi1 = s * i0 + c * i1;
          break;
        case RZ: case CRZ:  // diag(e^{-ia/2}, e^{+ia/2})
          *pr0 = c * r0 + s * i0;  *pi0 = c * i0 - s * r0;
          *pr1 = c * r1 - s * i1;  *pi1 = c * i1 + s * r1;
          break;
        case H:
          *pr0 = (r0 + r1) * kSqrt1_2;  *pi0 = (i0 + i1) * kSqrt1_2;
          *pr1 = (r0 - r1) * kSqrt1_2;  *pi1 = (i0 - i1) * kSqrt1_2;
          break;
        case CX:
          *pr0 = r1;  *pi0 = i1;  *pr1 = r0;  *pi1 = i0;
          break;
      }
    }
  }
}

// Write the block's `rows` states, held as [amplitude][stride] planes, to
// rows [0, rows) of a row-major (B, 2^n) complex128 tensor at `out`.
// Consecutive threads write consecutive amplitudes of one row, so the global
// stores coalesce; with an odd stride their shared-memory reads fall in
// distinct banks. Call after a __syncthreads().
__device__ __forceinline__ void store_states(double2* out, const double* re, const double* im,
                                             int stride, int rows, int n) {
  const int dim = 1 << n;
  for (int i = threadIdx.x; i < rows * dim; i += blockDim.x) {
    const int r = i >> n, k = i & (dim - 1);
    out[i] = make_double2(re[k * stride + r], im[k * stride + r]);
  }
}

}  // namespace dqgp
