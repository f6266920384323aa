// Fused-program Pauli-feature kernel (K3) for Hopper (sm_90a).
//
// Replaces dqgp_tpu/ops/pallas_circuit.py::make_pallas_pauli_features_fused_fn:
// per sample, run the gate-fused op program of dqgp_tpu_torch/ops/fusion.py
// on |0...0> and reduce each qubit q to <X_q>, <Y_q>, <Z_q>. Angles (B, G)
// float32 -> features (B, 3n) float32 laid out [X_0..X_{n-1} | Y_0.. |
// Z_0..], as K1 lays them out. float32 only, as the Pallas kernel is. Like
// the TPU function, which builds its packed coefficient rows from the angles
// (fusion.packed_inputs) inside the same call, the kernel forms each SU2
// op's fused 2x2 from its gates' angles itself, in fusion.su2_products'
// order (each new gate multiplied on the left), and reads each phase run's
// member angles (pi for a CZ) straight from the angle row.
//
// What bounds it on this card: FP32 issue. At config #7's 10 qubits a sample
// costs about 4.9e5 floating-point operations (chip_smoke.py counts them: 30
// SU2 ops over 512 amplitude pairs, two 10-term phase runs with a sine and a
// cosine per amplitude, the reduction) against 400 bytes of device memory.
// The lanes also trade ~1,400 shuffles a sample, which that bound omits.
//
// Design: a sample's state lives in registers across a lane group
// (warp_state.cuh): at 10 qubits a whole warp holds one sample, 32 complex
// amplitudes a lane, and gates on qubits 5..9 trade amplitudes through
// __shfl_xor_sync; at n <= 5 a lane holds a whole sample. Shared memory holds
// only the tables, the phase-pattern matrix C (permuted so that the lanes of
// a group read consecutive words) and, per warp, its samples' staged rows
// (angles loaded coalesced, at an odd stride, and the SU2 ops' 2x2s, which
// the lanes of a sample build in turn). Each lane writes its share of the
// features straight from the reduction. Blocks are persistent: each loads
// the tables once, then its warps walk the batch a warp-sized group of
// samples at a time, with no barrier after the tables are loaded. The
// kernel is templated on n (1..10), so every register index is a
// compile-time constant, and ptxas reports no stack frame and no spills for
// any of the ten. Trig is warp_state.cuh's sin_cos (sincosf's algorithm, no
// fast-math intrinsics): features are held to the plain fused engine at
// 8e-6.
//
// Interface: plain C, loaded with ctypes. The launch returns
// cudaGetLastError(), which the Python wrapper checks.

#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_state.cuh"

namespace {

using namespace dqgp::warp;

constexpr int kMaxThreads = 256;  // threads a block at most (the launch bound)
constexpr int kOpWords = 6;       // [type, qubit, control, first, count, aux]
constexpr int kGateWords = 2;     // [gate kind, gate index]
constexpr float kPi = 3.14159265358979f;
constexpr float kSqrt1_2 = 0.7071067811865476f;

// Gate kinds, as in dqgp_tpu_torch/ops/circuit.py.
enum { RX = 0, RY = 1, RZ = 2, H = 3, CRX = 6, CRY = 7, CRZ = 8 };

// One gate's 2x2 from its angle a, with c = cos(a/2), s = sin(a/2), as
// fusion._gate_matrix_entries builds it.
__device__ __forceinline__ Coef gate_matrix(int kind, float a) {
  if (kind == H) return {kSqrt1_2, 0.f, kSqrt1_2, 0.f, kSqrt1_2, 0.f, -kSqrt1_2, 0.f};
  float s, c;
  sin_cos(0.5f * a, &s, &c);
  if (kind == RX || kind == CRX) return {c, 0.f, 0.f, -s, 0.f, -s, c, 0.f};
  if (kind == RY || kind == CRY) return {c, 0.f, -s, 0.f, s, 0.f, c, 0.f};
  return {c, -s, 0.f, 0.f, 0.f, 0.f, c, s};  // RZ, CRZ
}

// x y + z w for complex x, y, z, w.
__device__ __forceinline__ void cmul_add(float xr, float xi, float yr, float yi,
                                         float zr, float zi, float wr, float wi,
                                         float* outr, float* outi) {
  *outr = (xr * yr - xi * yi) + (zr * wr - zi * wi);
  *outi = (xr * yi + xi * yr) + (zr * wi + zi * wr);
}

// g u, the new gate g on the left.
__device__ __forceinline__ Coef left_multiply(const Coef& g, const Coef& u) {
  Coef v;
  cmul_add(g.a0r, g.a0i, u.a0r, u.a0i, g.b0r, g.b0i, u.b1r, u.b1i, &v.a0r, &v.a0i);
  cmul_add(g.a0r, g.a0i, u.b0r, u.b0i, g.b0r, g.b0i, u.a1r, u.a1i, &v.b0r, &v.b0i);
  cmul_add(g.b1r, g.b1i, u.a0r, u.a0i, g.a1r, g.a1i, u.b1r, u.b1i, &v.b1r, &v.b1i);
  cmul_add(g.b1r, g.b1i, u.b0r, u.b0i, g.a1r, g.a1i, u.a1r, u.a1i, &v.a1r, &v.a1i);
  return v;
}

// An SU2 op's fused 2x2: the product of its `count` gates (gate-table
// entries e), the first applied rightmost, as fusion.su2_products forms it.
__device__ __forceinline__ Coef su2_product(const int* e, int count, const float* row) {
  Coef u = gate_matrix(e[0], row[e[1]]);
#pragma unroll 1
  for (int t = 1; t < count; ++t)
    u = left_multiply(gate_matrix(e[kGateWords * t], row[e[kGateWords * t + 1]]), u);
  return u;
}

// Tables (ops/cuda_circuit.py::k3_tables):
//   op rows [type, qubit, control, first, count, aux]:
//     SU2:  gates [first, first + count) of the gate table, aux = flags
//           (bit 0 real, bit 1 diagonal) | (where its 8 coefficients lie in
//           the staged row) << 2
//     PERM: a CX on qubit (target), control
//     DIAG: its K member angles lie at [first, first + K) of the staged row,
//           aux = first column of C
//   gate table rows [kind, index into the angle row], SU2 gates only;
//   member table: each DIAG member's index into the angle row, -1 for a CZ
//   (its angle is pi).
// A sample's staged row is its G angles, its members' angles and, where the
// sample spans several lanes, its SU2 ops' coefficients (8 an op), which the
// lanes of the sample build between them.

// Resident blocks an SM that the launch bound asks of ptxas: two (at most
// 128 registers a thread, 16 warps an SM) where the n-qubit instantiation
// fits them without spilling, as at 10 qubits (config #7) and at n <= 5. At
// 6-9 qubits, where a warp holds 2-16 samples, ptxas (CUDA 12.8) ends one
// to five registers over 128 whatever the variants tried, so those ask for
// one block an SM and take the registers they need. chip_smoke.py's phase 2
// fails if any instantiation spills or uses a stack frame.
template <int N>
struct MinBlocks {
  static constexpr int value = (N >= 6 && N <= 9) ? 1 : 2;
};

template <int N>
__global__ void __launch_bounds__(kMaxThreads, MinBlocks<N>::value)
warp_features_kernel(const float* __restrict__ angles,
                     const float* __restrict__ cperm,
                     const int* __restrict__ ops, const int* __restrict__ gates,
                     const int* __restrict__ members, float* __restrict__ out,
                     int B, int num_gates, int n_ops, int n_gates, int n_members,
                     int n_su2, int KT) {
  using Geo = Geometry<N>;
  constexpr int kF = 3 * N;            // features a sample
  extern __shared__ __align__(16) float smem[];
  const int op_words = kOpWords * n_ops, gate_words = kGateWords * n_gates;
  // the tables, then the batch loop's bound and stride
  const int table_words = (op_words + gate_words + n_members + 2 + 3) & ~3;
  const int coef_words = Geo::kL > 1 ? 8 * n_su2 : 0;
  const int rstride = (num_gates + n_members + coef_words) | 1;
  int* ops_s = reinterpret_cast<int*>(smem);
  int* gates_s = ops_s + op_words;
  int* members_s = gates_s + gate_words;
  volatile int* loop_s = members_s + n_members;  // [groups, stride]
  float* c_s = smem + table_words;  // [column][register][lane of the group]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // Per warp: its samples' staged rows, then one word that holds the group
  // index across the op loop (so that no register does).
  float* stage = c_s + Geo::kDim * KT + warp * (Geo::kSamples * rstride + 1);
  volatile int* group_word = reinterpret_cast<volatile int*>(stage + Geo::kSamples * rstride);

  for (int i = threadIdx.x; i < op_words; i += blockDim.x) ops_s[i] = ops[i];
  for (int i = threadIdx.x; i < gate_words; i += blockDim.x) gates_s[i] = gates[i];
  for (int i = threadIdx.x; i < n_members; i += blockDim.x) members_s[i] = members[i];
  if (threadIdx.x == 0) {
    loop_s[0] = (B + Geo::kSamples - 1) / Geo::kSamples;
    loop_s[1] = gridDim.x * (blockDim.x >> 5);
  }
  for (int i = threadIdx.x; i < Geo::kDim * KT; i += blockDim.x) c_s[i] = cperm[i];
  __syncthreads();

  const int lig = lane & (Geo::kL - 1);  // lane within the sample's group
  const int sw = lane / Geo::kL;         // the warp's sample this lane works on
  float* row = stage + sw * rstride;
  // Nothing of the batch loop stays live across the op loop beside the
  // state: the group index, the loop's bound and its stride wait in shared
  // memory (volatile words, so the compiler reloads them), and which of the
  // group's samples exist (s0 + s < B) is tested where it is needed.
  for (int g = blockIdx.x * (blockDim.x >> 5) + warp; g < loop_s[0];) {
    const int s0 = g * Geo::kSamples;
    __syncwarp();
    if (lane == 0) *group_word = g;
    for (int s = 0; s < Geo::kSamples; ++s) {
      const bool here = s0 + s < B;
      const float* src = angles + (long long)(s0 + s) * num_gates;
      float* dst = stage + s * rstride;
      for (int j = lane; j < num_gates; j += 32) dst[j] = here ? src[j] : 0.f;
      for (int j = lane; j < n_members; j += 32) {
        const int gi = members_s[j];
        dst[num_gates + j] = !here ? 0.f : gi >= 0 ? src[gi] : kPi;
      }
    }
    __syncwarp();
    if constexpr (Geo::kL > 1) {
      // the lanes of a sample take its SU2 ops in turn (the ops' coefficient
      // offsets in the row step by 8)
#pragma unroll 1
      for (int o = 0; o < n_ops; ++o) {
        const int* op = ops_s + kOpWords * o;
        const int at = op[5] >> 2;
        if (op[0] != OP_SU2 || ((at >> 3) & (Geo::kL - 1)) != lig) continue;
        const Coef u = su2_product(gates_s + kGateWords * op[3], op[4], row);
        float* c = row + at;
        c[0] = u.a0r; c[1] = u.a0i; c[2] = u.b0r; c[3] = u.b0i;
        c[4] = u.b1r; c[5] = u.b1i; c[6] = u.a1r; c[7] = u.a1i;
      }
      __syncwarp();
    }

    float re[Geo::kA], im[Geo::kA];
#pragma unroll
    for (int r = 0; r < Geo::kA; ++r) {
      re[r] = 0.f;
      im[r] = 0.f;
    }
    re[0] = lig == 0 ? 1.f : 0.f;

    for (int o = 0; o < n_ops; ++o) {
      const int* op = ops_s + kOpWords * o;
      const int type = op[0], q = op[1], ctl = op[2];
      const int first = op[3], count = op[4], aux = op[5];
      if (type == OP_SU2) {
        Coef u;
        if constexpr (Geo::kL > 1) {
          const float* c = row + (aux >> 2);
          u = Coef{c[0], c[1], c[2], c[3], c[4], c[5], c[6], c[7]};
        } else {  // a lane holds the whole sample: it builds each 2x2 here
          u = su2_product(gates_s + kGateWords * first, count, row);
        }
        apply_su2<N>(re, im, u, aux & 3, q, lig, make_control(ctl, lig));
      } else if (type == OP_PERM) {
        perm<N>(re, im, q, make_control(ctl, lig));
      } else {
        const float* a = row + first;
        apply_diag<N>(re, im, c_s + aux * Geo::kDim + lig, count,
                      [a](int j) { return a[j]; });
      }
    }

    // each lane of the sample writes its share of the features straight to
    // the output row (13 MB at config #7's step: no staging for them)
    g = *group_word;
    const int b = g * Geo::kSamples + sw;
    reduce_features<N>(re, im, lig, out + (long long)b * kF, b < B);
    g += loop_s[1];
  }
}

// Resident blocks an SM of the n-qubit instantiation at this block size and
// shared memory, after allowing it that much dynamic shared memory.
template <int N>
cudaError_t resident_blocks(int tpb, long long smem_bytes, int* per_sm) {
  cudaError_t e = cudaFuncSetAttribute(warp_features_kernel<N>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem_bytes);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, warp_features_kernel<N>,
                                                       tpb, (size_t)smem_bytes);
}

// One persistent launch: as many blocks as the SMs hold at once, or fewer
// where the batch needs fewer.
template <int N>
int launch(const float* angles, const float* cperm, const int* ops,
           const int* gates, const int* members, float* out, int B,
           int num_gates, int n_ops, int n_gates, int n_members, int n_su2,
           int KT, int tpb, long long smem_bytes, cudaStream_t stream) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = resident_blocks<N>(tpb, smem_bytes, &per_sm);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long warps = tpb / 32;
  const long long groups = ((long long)B + Geometry<N>::kSamples - 1) / Geometry<N>::kSamples;
  const long long wanted = (groups + warps - 1) / warps;
  const int blocks = (int)(wanted < (long long)per_sm * sms ? wanted : (long long)per_sm * sms);
  warp_features_kernel<N><<<blocks, tpb, (size_t)smem_bytes, stream>>>(
      angles, cperm, ops, gates, members, out, B, num_gates, n_ops, n_gates,
      n_members, n_su2, KT);
  return (int)cudaGetLastError();
}

template <int N>
int blocks_per_sm(int tpb, long long smem_bytes) {
  int per_sm = 0;
  return resident_blocks<N>(tpb, smem_bytes, &per_sm) == cudaSuccess ? per_sm : -1;
}

}  // namespace

#define DQGP_FOR_EACH_N(X) \
  X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8) X(9) X(10)

extern "C" {

// angles points at a (B, num_gates) float32 tensor, cperm at C permuted
// (KT, 2^n) as [column][register][lane of the group], ops at the (n_ops, 6),
// gates at the (n_gates, 2) and members at the (n_members,) int32 tables,
// out at (B, 3n) float32. Returns cudaGetLastError().
int dqgp_pauli_features_fused(const float* angles, const float* cperm,
                              const int* ops, const int* gates,
                              const int* members, float* out, int B, int n,
                              int num_gates, int n_ops, int n_gates,
                              int n_members, int n_su2, int KT, int tpb,
                              long long smem_bytes, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (n) {
#define DQGP_CASE(N)                                                          \
  case N:                                                                     \
    return launch<N>(angles, cperm, ops, gates, members, out, B, num_gates,  \
                     n_ops, n_gates, n_members, n_su2, KT, tpb, smem_bytes,  \
                     s);
    DQGP_FOR_EACH_N(DQGP_CASE)
#undef DQGP_CASE
  }
  return (int)cudaErrorInvalidValue;
}

// Resident blocks an SM holds of the n-qubit instantiation at this block
// size and shared memory (-1 on error).
int dqgp_pauli_features_fused_blocks_per_sm(int n, int tpb, long long smem_bytes) {
  switch (n) {
#define DQGP_CASE(N) \
  case N:            \
    return blocks_per_sm<N>(tpb, smem_bytes);
    DQGP_FOR_EACH_N(DQGP_CASE)
#undef DQGP_CASE
  }
  return -1;
}

const char* dqgp_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
