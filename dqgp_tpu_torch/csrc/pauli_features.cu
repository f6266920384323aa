// Pauli-feature kernel (K1) for Hopper (sm_90a).
//
// Replaces dqgp_tpu/ops/pallas_circuit.py::make_pallas_pauli_features_fn:
// per sample, run the encoding circuit's gate sequence on |0...0> and reduce
// each qubit q to <X_q>, <Y_q>, <Z_q>. angles (B, G) float32 -> features
// (B, 3n) float32, laid out [X_0..X_{n-1} | Y_0.. | Z_0..].
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
// inside the gate loop. The block's angle rows are staged into shared memory
// with coalesced loads, each row padded to an odd stride so that the
// per-thread reads do not conflict either. The gate table (kind, qubit,
// control) is a small int32 device array that every thread reads at the same
// address. Trig uses sincosf (no fast-math intrinsics): the features are
// held to the plain PyTorch engine at 5e-6.
//
// Interface: plain C, loaded with ctypes. The launch returns
// cudaGetLastError(), which the Python wrapper checks.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Gate kinds, as in dqgp_tpu_torch/ops/circuit.py.
enum { RX = 0, RY, RZ, H, CX, CZ, CRX, CRY, CRZ, RZZ };

constexpr float kSqrt1_2 = 0.7071067811865476f;

__global__ void pauli_features_kernel(const float* __restrict__ angles,
                                      const int* __restrict__ gates,
                                      float* __restrict__ out,
                                      int B, int G, int n, int gstride) {
  extern __shared__ float smem[];
  const int tpb = blockDim.x;
  const int tid = threadIdx.x;
  const int dim = 1 << n;
  float* re = smem;                       // [dim][tpb]
  float* im = re + (size_t)dim * tpb;     // [dim][tpb]
  float* ang = im + (size_t)dim * tpb;    // [tpb][gstride]

  const long long b0 = (long long)blockIdx.x * tpb;
  const int rows = (int)min((long long)tpb, (long long)B - b0);

  // Stage this block's angle rows (contiguous in the (B, G) input).
  const float* src = angles + b0 * G;
  for (int i = tid; i < rows * G; i += tpb) {
    const int r = i / G;
    ang[r * gstride + (i - r * G)] = src[i];
  }
  for (int k = 0; k < dim; ++k) {
    re[k * tpb + tid] = (k == 0) ? 1.0f : 0.0f;
    im[k * tpb + tid] = 0.0f;
  }
  __syncthreads();
  if (tid >= rows) return;

  const float* a_row = ang + tid * gstride;
  const int half_dim = dim >> 1;
  for (int g = 0; g < G; ++g) {
    const int kind = __ldg(gates + 3 * g);
    const int q = __ldg(gates + 3 * g + 1);
    const int ctl = __ldg(gates + 3 * g + 2);
    float c = 1.0f, s = 0.0f;
    if (kind != H && kind != CX && kind != CZ) sincosf(0.5f * a_row[g], &s, &c);

    if (kind == CZ || kind == RZZ) {
      // Diagonal two-qubit gates: one pass over all amplitudes.
      for (int k = 0; k < dim; ++k) {
        const int bq = (k >> q) & 1, bc = (k >> ctl) & 1;
        float* pr = re + k * tpb + tid;
        float* pi = im + k * tpb + tid;
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
      continue;
    }

    const int lo = (1 << q) - 1;
    for (int p = 0; p < half_dim; ++p) {
      const int k0 = ((p >> q) << (q + 1)) | (p & lo);
      const int k1 = k0 | (1 << q);
      if (ctl >= 0 && !((k0 >> ctl) & 1)) continue;  // control bit clear
      float* pr0 = re + k0 * tpb + tid;
      float* pi0 = im + k0 * tpb + tid;
      float* pr1 = re + k1 * tpb + tid;
      float* pi1 = im + k1 * tpb + tid;
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

  // <X_q> = 2 sum_{bit q = 0} Re(conj(s0) s1), <Y_q> = 2 sum Im(conj(s0) s1),
  // <Z_q> = sum (1 - 2 bit_q) |s|^2.
  float* o = out + (b0 + tid) * 3 * n;
  for (int q = 0; q < n; ++q) {
    const int lo = (1 << q) - 1;
    float x = 0.0f, y = 0.0f, z = 0.0f;
    for (int p = 0; p < half_dim; ++p) {
      const int k0 = ((p >> q) << (q + 1)) | (p & lo);
      const int k1 = k0 | (1 << q);
      const float r0 = re[k0 * tpb + tid], i0 = im[k0 * tpb + tid];
      const float r1 = re[k1 * tpb + tid], i1 = im[k1 * tpb + tid];
      x += r0 * r1 + i0 * i1;
      y += r0 * i1 - i0 * r1;
      z += (r0 * r0 + i0 * i0) - (r1 * r1 + i1 * i1);
    }
    o[q] = 2.0f * x;
    o[n + q] = 2.0f * y;
    o[2 * n + q] = z;
  }
}

}  // namespace

extern "C" {

// Launch on `stream`; returns cudaGetLastError() (0 = success).
int dqgp_pauli_features(const float* angles, const int* gates, float* out,
                        int B, int G, int n, int tpb, int gstride,
                        long long smem_bytes, void* stream) {
  if (smem_bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        pauli_features_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (B + tpb - 1) / tpb;
  pauli_features_kernel<<<blocks, tpb, (size_t)smem_bytes,
                          (cudaStream_t)stream>>>(angles, gates, out, B, G, n,
                                                  gstride);
  return (int)cudaGetLastError();
}

const char* dqgp_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
