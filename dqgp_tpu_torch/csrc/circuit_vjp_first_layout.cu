// The adjoint kernel's first layout (one thread a sample, both states in
// shared memory), kept beside its redesign (circuit_vjp.cu) so that
// chip_smoke.py's phase 15a can time the two in turns in one call. The
// package does not launch it.
//
// Adjoint (vector-Jacobian product) kernel of the circuit, for Hopper
// (sm_90a), first layout: the backward of the Pauli-feature kernel (K1)
// and of the states kernel (K2), float32.
//
// Given a sample's angles a (G,) and the cotangent of its output, compute
// dL/da (G,) by adjoint differentiation. Every gate with an angle is
// U_j = exp(-i a_j/2 P_j), P_j its generator (X, Y or Z on its qubit,
// restricted to the control's 1-subspace for CRX/CRY/CRZ, Z (x) Z for
// RZZ), so with phi_j = U_j ... U_1 |0...0> and lambda_j = U_{j+1}^H ...
// U_G^H lambda_G,
//
//     dL/da_j = 1/2 Im <lambda_j | P_j | phi_j>,
//
// where lambda_G is the state's cotangent (torch's convention for a real
// loss of a complex output) or, for the features <X_q>, <Y_q>, <Z_q> with
// cotangent (gx, gy, gz), lambda_G = 2 O psi, O = sum_q gx_q X_q + gy_q Y_q
// + gz_q Z_q. The kernel runs the forward sequence to psi = phi_G, seeds
// lambda, then walks the gates backwards: the gradient of gate j, then
// U_j^H = U_j(-a_j) (H, CX and CZ are their own inverses) on both states.
// The JAX package has no such kernel: its Pallas kernels have no VJP, and
// its autodiff gradient differentiates its XLA statevector engine.
//
// Design: the layout of statevector.cuh's float64 gate loop, in float32.
// One thread runs one sample; its two states (phi and lambda) live in
// shared memory as [amplitude][thread] planes, so the threads of a warp
// touch consecutive words at every step, and the block's angle rows are
// staged with coalesced loads at an odd stride. The backward pass writes
// each gate's gradient over its (no longer needed) angle, and the block
// stores its gradient rows coalesced at the end. Threads per block halve
// from 128 until the states fit the shared-memory budget
// (chip_smoke.py::vjp_first_layout_config). Trig is sincosf.
//
// Interface: plain C, loaded with ctypes. The launch returns
// cudaGetLastError(), which the Python wrapper checks.

#include <cuda_runtime.h>

namespace {

// Gate kinds, as in dqgp_tpu_torch/ops/circuit.py.
enum { RX = 0, RY, RZ, H, CX, CZ, CRX, CRY, CRZ, RZZ };

constexpr float kSqrt1_2 = 0.70710678118654752f;

__device__ __forceinline__ bool has_angle(int kind) {
  return kind != H && kind != CX && kind != CZ;
}

// Apply one gate (its half angle's cosine c and sine s) to the state whose
// amplitude k lies at re[k * stride], im[k * stride]. With -s in place of s
// a rotation applies its inverse.
__device__ inline void apply_gate(float* re, float* im, int stride, int kind, int q,
                                  int ctl, float c, float s, int n) {
  const int dim = 1 << n;
  if (kind == CZ || kind == RZZ) {
    for (int k = 0; k < dim; ++k) {
      const int bq = (k >> q) & 1, bc = (k >> ctl) & 1;
      float* pr = re + k * stride;
      float* pi = im + k * stride;
      if (kind == CZ) {
        if (bq & bc) { *pr = -*pr; *pi = -*pi; }
      } else {
        // exp(-i a/2 * sgn), sgn = +1 where the bits agree.
        const float sg = (bq == bc) ? s : -s;
        const float r0 = *pr, i0 = *pi;
        *pr = c * r0 + sg * i0;
        *pi = c * i0 - sg * r0;
      }
    }
    return;
  }
  const int lo = (1 << q) - 1;
  for (int p = 0; p < (dim >> 1); ++p) {
    const int k0 = ((p >> q) << (q + 1)) | (p & lo);
    const int k1 = k0 | (1 << q);
    if (ctl >= 0 && !((k0 >> ctl) & 1)) continue;  // control bit clear
    float* pr0 = re + k0 * stride;
    float* pi0 = im + k0 * stride;
    float* pr1 = re + k1 * stride;
    float* pi1 = im + k1 * stride;
    const float r0 = *pr0, i0 = *pi0, r1 = *pr1, i1 = *pi1;
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

// Im <lambda | P | phi> for the generator P of a gate with an angle.
__device__ inline float generator_im(const float* pr, const float* pi, const float* lr,
                                     const float* li, int stride, int kind, int q, int ctl,
                                     int n) {
  const int dim = 1 << n;
  float acc = 0.f;
  if (kind == RZZ) {
    for (int k = 0; k < dim; ++k) {
      const float t = lr[k * stride] * pi[k * stride] - li[k * stride] * pr[k * stride];
      acc += (((k >> q) ^ (k >> ctl)) & 1) ? -t : t;
    }
    return acc;
  }
  const int lo = (1 << q) - 1;
  for (int p = 0; p < (dim >> 1); ++p) {
    const int k0 = ((p >> q) << (q + 1)) | (p & lo);
    const int k1 = k0 | (1 << q);
    if (ctl >= 0 && !((k0 >> ctl) & 1)) continue;
    const float p0r = pr[k0 * stride], p0i = pi[k0 * stride];
    const float p1r = pr[k1 * stride], p1i = pi[k1 * stride];
    const float l0r = lr[k0 * stride], l0i = li[k0 * stride];
    const float l1r = lr[k1 * stride], l1i = li[k1 * stride];
    switch (kind) {
      case RX: case CRX:  // X phi = (phi1, phi0)
        acc += l0r * p1i - l0i * p1r + l1r * p0i - l1i * p0r;
        break;
      case RY: case CRY:  // Y phi = (-i phi1, i phi0)
        acc += -l0r * p1r - l0i * p1i + l1r * p0r + l1i * p0i;
        break;
      default:            // RZ, CRZ: Z phi = (phi0, -phi1)
        acc += l0r * p0i - l0i * p0r - l1r * p1i + l1i * p1r;
        break;
    }
  }
  return acc;
}

// mode 0: cot points at the (B, 3n) feature cotangent [X | Y | Z]; mode 1:
// at the (B, 2^n) complex64 state cotangent as (re, im) pairs. grad points
// at the (B, G) float32 output.
__global__ void circuit_vjp_kernel(const float* __restrict__ angles,
                                   const int* __restrict__ gates,
                                   const float* __restrict__ cot,
                                   float* __restrict__ grad, int B, int G, int n,
                                   int mode, int gstride) {
  extern __shared__ __align__(16) float smem[];
  const int tpb = blockDim.x;
  const int tid = threadIdx.x;
  const int dim = 1 << n;
  float* pr = smem + tid;                    // phi, [dim][tpb]
  float* pi = pr + (size_t)dim * tpb;
  float* lr = pi + (size_t)dim * tpb;        // lambda, [dim][tpb]
  float* li = lr + (size_t)dim * tpb;
  float* rows = smem + (size_t)4 * dim * tpb;  // [tpb][gstride]

  const long long b0 = (long long)blockIdx.x * tpb;
  const int nrows = (int)min((long long)tpb, (long long)B - b0);
  for (int i = tid; i < nrows * G; i += tpb) {
    const int r = i / G;
    rows[r * gstride + (i - r * G)] = angles[b0 * G + i];
  }
  __syncthreads();

  if (tid < nrows) {
    float* a = rows + tid * gstride;
    const long long b = b0 + tid;
    for (int k = 0; k < dim; ++k) {
      pr[k * tpb] = (k == 0) ? 1.f : 0.f;
      pi[k * tpb] = 0.f;
    }
    for (int g = 0; g < G; ++g) {
      const int kind = __ldg(gates + 3 * g);
      float c = 1.f, s = 0.f;
      if (has_angle(kind)) sincosf(0.5f * a[g], &s, &c);
      apply_gate(pr, pi, tpb, kind, __ldg(gates + 3 * g + 1), __ldg(gates + 3 * g + 2), c, s, n);
    }

    // lambda_G
    if (mode == 0) {
      for (int k = 0; k < dim; ++k) {
        lr[k * tpb] = 0.f;
        li[k * tpb] = 0.f;
      }
      const float* g3 = cot + b * 3 * n;
      for (int q = 0; q < n; ++q) {
        const float gx = 2.f * g3[q], gy = 2.f * g3[n + q], gz = 2.f * g3[2 * n + q];
        const int lo = (1 << q) - 1;
        for (int p = 0; p < (dim >> 1); ++p) {
          const int k0 = ((p >> q) << (q + 1)) | (p & lo);
          const int k1 = k0 | (1 << q);
          const float p0r = pr[k0 * tpb], p0i = pi[k0 * tpb];
          const float p1r = pr[k1 * tpb], p1i = pi[k1 * tpb];
          lr[k0 * tpb] += gx * p1r + gy * p1i + gz * p0r;
          li[k0 * tpb] += gx * p1i - gy * p1r + gz * p0i;
          lr[k1 * tpb] += gx * p0r - gy * p0i - gz * p1r;
          li[k1 * tpb] += gx * p0i + gy * p0r - gz * p1i;
        }
      }
    } else {
      const float2* st = reinterpret_cast<const float2*>(cot) + b * dim;
      for (int k = 0; k < dim; ++k) {
        const float2 v = st[k];
        lr[k * tpb] = v.x;
        li[k * tpb] = v.y;
      }
    }

    for (int g = G - 1; g >= 0; --g) {
      const int kind = __ldg(gates + 3 * g);
      const int q = __ldg(gates + 3 * g + 1);
      const int ctl = __ldg(gates + 3 * g + 2);
      float d = 0.f, c = 1.f, s = 0.f;
      if (has_angle(kind)) {
        d = 0.5f * generator_im(pr, pi, lr, li, tpb, kind, q, ctl, n);
        sincosf(0.5f * a[g], &s, &c);
      }
      if (g > 0) {
        apply_gate(pr, pi, tpb, kind, q, ctl, c, -s, n);
        apply_gate(lr, li, tpb, kind, q, ctl, c, -s, n);
      }
      a[g] = d;
    }
  }
  __syncthreads();
  for (int i = tid; i < nrows * G; i += tpb) {
    const int r = i / G;
    grad[b0 * G + i] = rows[r * gstride + (i - r * G)];
  }
}

}  // namespace

extern "C" {

// angles points at a (B, G) float32 tensor, gates at the (G, 3) int32 table
// [kind, qubit, control] (qubit q on bit q), cot at the cotangent (mode 0:
// (B, 3n) float32 features; mode 1: (B, 2^n) complex64 states), grad at a
// (B, G) float32 tensor. Returns cudaGetLastError().
int dqgp_circuit_vjp_first_layout(const float* angles, const int* gates, const float* cot,
                                  float* grad, int B, int G, int n, int mode, int tpb,
                                  int gstride, long long smem_bytes, void* stream) {
  if (smem_bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        circuit_vjp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (B + tpb - 1) / tpb;
  circuit_vjp_kernel<<<blocks, tpb, (size_t)smem_bytes, (cudaStream_t)stream>>>(
      angles, gates, cot, grad, B, G, n, mode, gstride);
  return (int)cudaGetLastError();
}

const char* dqgp_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
