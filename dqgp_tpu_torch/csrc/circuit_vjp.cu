// Adjoint (vector-Jacobian product) kernel of the circuit, for Hopper
// (sm_90a): the backward of the Pauli-feature kernel (K1) and of the states
// kernel (K2), float32.
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
// its autodiff gradient differentiates its XLA statevector engine
// (dqgp_tpu/parallel/consensus.py:145-160).
//
// What bounds it on this card: operations. A sample costs about three
// passes of the gate sequence (forward, then the inverse on two states),
// the generators' inner products and the seed: 1.48e6 operations at config
// #7's circuit (10 qubits, G=70) against 8.6 KB of angles, cotangent and
// gradient, so the autodiff step's B=54,016 launch is bound at ~1.2 ms by
// the FP32 rate. At the north star's B=1,040, 4 qubits, it is latency: 33
// warps, each lane walking its sample's 40 gates three times back to back.
//
// Design (warp_vjp_kernel): the register layout of the forward kernels
// (warp_state.cuh). A sample's two states, phi and lambda, live in
// registers across a lane group (a lane a sample at n <= 5, 2^(n-5) lanes
// above, a whole warp at 10 qubits): 64 floats a state a lane from 5
// qubits up, 128 for the two, so those instantiations ask for one block an
// SM (255 registers a thread) and those up to 4 qubits for two. The forward
// sequence is run_gate_batch's, with its staging of the angle rows; the
// backward walk applies each inverse gate to both states through
// apply_gate_cs, with one sin_cos a gate for the two. A gate's gradient
// is a lane's partial of Im <lambda|P|phi> (over register pairs, or with
// the partner lane's phi by __shfl_xor_sync where the target is a lane
// bit; diagonal generators need no partner). Where a lane holds a sample it
// writes the gradient over the gate's angle in the staged row; where a
// sample spans lanes, each lane keeps its partials in shared memory and
// the group's sums are taken once after the walk, over the angles. The warp
// then stores its samples' gradient rows as one coalesced run. The
// features variant seeds lambda from the cotangent with qubit q on bit q
// (K1's map); the states variant reads the state's cotangent in K2's map
// (qubits 0..n-6 on the lane bits) and walks K2's gate table, so that the
// lanes of a sample read consecutive amplitudes. Templated on n (1..10); no register array is
// indexed at run time. Trig is warp_state.cuh's sin_cos.
//
// Interface: plain C, loaded with ctypes. The launch returns
// cudaGetLastError(), which the Python wrapper checks.

#include <cuda_runtime.h>

#include "warp_state.cuh"

namespace {

using namespace dqgp::warp;

// Resident blocks an SM that each instantiation asks of ptxas: up to 4
// qubits the two states are at most 64 registers and two blocks of
// kMaxThreads fit (128 registers a thread); from 5 qubits up they are 128,
// and one block takes up to 255 registers a thread.
template <int N>
struct VjpMinBlocks {
  static constexpr int value = N <= 4 ? 2 : 1;
};

// A generator's sum over a lane's registers runs in kAccs independent
// partial sums, so that its adds do not wait on each other.
constexpr int kAccs = 4;

__device__ __forceinline__ float sum_accs(const float (&acc)[kAccs]) {
  return (acc[0] + acc[1]) + (acc[2] + acc[3]);
}

// Im <lambda | X phi> (Y = false) or Im <lambda | Y phi> (Y = true) over the
// amplitudes of this lane that the control lets through, the target on bit
// q: amplitude k meets phi at k with bit q flipped, in this lane's
// registers (a register bit) or the partner lane's (a lane bit). For Y,
// (Y phi)_k = -i phi_{k'} where bit q of k is clear and +i phi_{k'} where
// it is set.
template <int N, bool Y, int Q = 0>
__device__ __forceinline__ float generator_xy(const float (&pr)[Geometry<N>::kA],
                                              const float (&pi)[Geometry<N>::kA],
                                              const float (&lr)[Geometry<N>::kA],
                                              const float (&li)[Geometry<N>::kA],
                                              int q, int lig, Control c) {
  using Geo = Geometry<N>;
  if constexpr (Q < Geo::kRegBits) {
    if (q != Q) return generator_xy<N, Y, Q + 1>(pr, pi, lr, li, q, lig, c);
    float acc[kAccs] = {};
#pragma unroll
    for (int r = 0; r < Geo::kA; ++r) {
      const int o = r ^ (1 << Q);
      const float t = Y ? (((r >> Q) & 1) ? 1.f : -1.f) * (lr[r] * pr[o] + li[r] * pi[o])
                        : lr[r] * pi[o] - li[r] * pr[o];
      if (c.lane_ok && (r & c.reg_mask) == c.reg_mask) acc[r % kAccs] += t;
    }
    return sum_accs(acc);
  } else if constexpr (Geo::kL > 1) {
    const int m = 1 << (q - 5);
    const float sign = (lig & m) ? 1.f : -1.f;
    float acc[kAccs] = {};
#pragma unroll
    for (int r = 0; r < Geo::kA; ++r) {
      const float ppr = __shfl_xor_sync(kFullMask, pr[r], m, Geo::kL);
      const float ppi = __shfl_xor_sync(kFullMask, pi[r], m, Geo::kL);
      const float t = Y ? sign * (lr[r] * ppr + li[r] * ppi) : lr[r] * ppi - li[r] * ppr;
      if (c.lane_ok && (r & c.reg_mask) == c.reg_mask) acc[r % kAccs] += t;
    }
    return sum_accs(acc);
  } else {
    return 0.f;
  }
}

// Im <lambda | P phi> for a diagonal generator over this lane's amplitudes:
// Z on bit q where the control lets through (RZ, CRZ), or Z (x) Z on bits q
// and ctl (RZZ): +1 where the bits agree, -1 where they differ.
template <int N>
__device__ __forceinline__ float generator_diag(const float (&pr)[Geometry<N>::kA],
                                                const float (&pi)[Geometry<N>::kA],
                                                const float (&lr)[Geometry<N>::kA],
                                                const float (&li)[Geometry<N>::kA],
                                                bool zz, int q, int ctl, int lig) {
  const Bit bq = make_bit(q, lig);
  const Bit bc = make_bit(zz ? ctl : q, lig);
  const Control on = make_control(zz ? -1 : ctl, lig);
  float acc[kAccs] = {};
#pragma unroll
  for (int r = 0; r < Geometry<N>::kA; ++r) {
    const bool one_q = bq.lane_set || (r & bq.reg_mask) != 0;
    const bool one_c = bc.lane_set || (r & bc.reg_mask) != 0;
    const float t = lr[r] * pi[r] - li[r] * pr[r];
    const bool minus = zz ? one_q != one_c : one_q;
    if (on.lane_ok && (r & on.reg_mask) == on.reg_mask) acc[r % kAccs] += minus ? -t : t;
  }
  return sum_accs(acc);
}

// lambda += 2 (gx X_q + gy Y_q + gz Z_q) phi for every qubit q (qubit q on
// bit q), (gx, gy, gz) the sample's feature cotangent c3 = [X | Y | Z], or
// zero where the sample does not exist.
template <int N, int Q = 0>
__device__ __forceinline__ void seed_features(const float (&pr)[Geometry<N>::kA],
                                              const float (&pi)[Geometry<N>::kA],
                                              float (&lr)[Geometry<N>::kA],
                                              float (&li)[Geometry<N>::kA], int lig,
                                              const float* __restrict__ c3, bool here) {
  using Geo = Geometry<N>;
  if constexpr (Q < N) {
    const float gx = here ? 2.f * __ldg(c3 + Q) : 0.f;
    const float gy = here ? 2.f * __ldg(c3 + N + Q) : 0.f;
    const float gz = here ? 2.f * __ldg(c3 + 2 * N + Q) : 0.f;
    if constexpr (Q < Geo::kRegBits) {
#pragma unroll
      for (int p = 0; p < Geo::kA / 2; ++p) {
        const int k0 = ((p >> Q) << (Q + 1)) | (p & ((1 << Q) - 1));
        const int k1 = k0 | (1 << Q);
        const float p0r = pr[k0], p0i = pi[k0], p1r = pr[k1], p1i = pi[k1];
        lr[k0] += gx * p1r + gy * p1i + gz * p0r;
        li[k0] += gx * p1i - gy * p1r + gz * p0i;
        lr[k1] += gx * p0r - gy * p0i - gz * p1r;
        li[k1] += gx * p0i + gy * p0r - gz * p1i;
      }
    } else {
      // this lane holds the amplitude with bit q clear (Y phi = -i phi') or
      // set (Y phi = +i phi', Z phi = -phi); the partner lane the other
      constexpr int m = 1 << (Q - 5);
      const bool hi = (lig & m) != 0;
      const float ys = hi ? -gy : gy, zs = hi ? -gz : gz;
#pragma unroll
      for (int r = 0; r < Geo::kA; ++r) {
        const float ppr = __shfl_xor_sync(kFullMask, pr[r], m, Geo::kL);
        const float ppi = __shfl_xor_sync(kFullMask, pi[r], m, Geo::kL);
        lr[r] += gx * ppr + ys * ppi + zs * pr[r];
        li[r] += gx * ppi - ys * ppr + zs * pi[r];
      }
    }
    seed_features<N, Q + 1>(pr, pi, lr, li, lig, c3, here);
  }
}

// lambda = the state's cotangent, read in the states kernels' map:
// amplitude k of the sample's row is register k >> (N-5) of lane k & (L-1)
// (register k of the one lane at N <= 5), so for each register the lanes of
// a sample read consecutive complex64.
template <int N>
__device__ __forceinline__ void seed_states(float (&lr)[Geometry<N>::kA],
                                            float (&li)[Geometry<N>::kA], int lig,
                                            const float2* __restrict__ st, bool here) {
  using Geo = Geometry<N>;
#pragma unroll
  for (int r = 0; r < Geo::kA; ++r) {
    const float2 v = here ? __ldg(st + r * Geo::kL + lig) : make_float2(0.f, 0.f);
    lr[r] = v.x;
    li[r] = v.y;
  }
}

// cot points at the (B, 3N) float32 feature cotangent (states = 0) or at the
// (B, 2^N) complex64 state cotangent (states = 1), grad at the (B, G)
// float32 output; gates is the (G, 3) table under the matching bit map.
template <int N>
__global__ void __launch_bounds__(kMaxThreads, VjpMinBlocks<N>::value)
warp_vjp_kernel(const float* __restrict__ angles, const int* __restrict__ gates,
                const float* __restrict__ cot, float* __restrict__ grad, int B, int G,
                int states) {
  using Geo = Geometry<N>;
  run_gate_batch<N>(angles, gates, B, G,
                    [=](const float (&re)[Geo::kA], const float (&im)[Geo::kA], int lig,
                        int b, const Staged& st) {
    const bool here = b < B;
    float pr[Geo::kA], pi[Geo::kA], lr[Geo::kA], li[Geo::kA];
#pragma unroll
    for (int r = 0; r < Geo::kA; ++r) {
      pr[r] = re[r];
      pi[r] = im[r];
      lr[r] = 0.f;
      li[r] = 0.f;
    }
    if (states) {
      seed_states<N>(lr, li, lig, reinterpret_cast<const float2*>(cot) + (long long)b * Geo::kDim,
                     here);
    } else {
      seed_features<N>(pr, pi, lr, li, lig, cot + (long long)b * (3 * N), here);
    }

    const int lane = threadIdx.x & 31;
    // Where a sample spans lanes, a gate's gradient is a sum over the lane
    // group: each lane keeps its partial of every gate in shared memory (G
    // words at an odd stride from the next lane's; the launch adds a warp's
    // 32 x (G | 1) words to the block) until the walk ends.
    float* part = st.scratch + (threadIdx.x >> 5) * 32 * st.rstride + lane * st.rstride;
    for (int j = G - 1; j >= 0; --j) {
      const int* gate = st.gates + kGateFields * j;
      const int kind = gate[0], q = gate[1], ctl = gate[2];
      const float a = st.row[j];
      float d = 0.f;
      if (has_angle(kind)) {
        if (kind == RZ || kind == CRZ || kind == RZZ) {
          d = generator_diag<N>(pr, pi, lr, li, kind == RZZ, q, ctl, lig);
        } else if (kind == RY || kind == CRY) {
          d = generator_xy<N, true>(pr, pi, lr, li, q, lig, make_control(ctl, lig));
        } else {
          d = generator_xy<N, false>(pr, pi, lr, li, q, lig, make_control(ctl, lig));
        }
      }
      if (j > 0) {  // U_j^H on both states
        float s = 0.f, c = 1.f;
        if (has_angle(kind)) sin_cos(0.5f * a, &s, &c);
        apply_gate_cs<N>(pr, pi, kind, q, ctl, c, -s, lig);
        apply_gate_cs<N>(lr, li, kind, q, ctl, c, -s, lig);
      }
      if constexpr (Geo::kL > 1) {
        part[j] = d;
      } else {  // a lane's own sample: the gradient over the gate's angle
        st.row[j] = 0.5f * d;
      }
    }
    __syncwarp();
    if constexpr (Geo::kL > 1) {
      // each of the warp's samples' G gradients: the sum of its L lanes'
      // partials, written over the angles (consecutive lanes, consecutive
      // gates: no bank conflicts at the odd stride)
      const float* parts = st.scratch + (threadIdx.x >> 5) * 32 * st.rstride;
      for (int i = lane; i < Geo::kSamples * G; i += 32) {
        const int s = i / G, j = i - s * G;
        float acc = 0.f;
#pragma unroll
        for (int l = 0; l < Geo::kL; ++l) acc += parts[(s * Geo::kL + l) * st.rstride + j];
        st.rows[s * st.rstride + j] = 0.5f * acc;
      }
      __syncwarp();
    }

    // the warp's samples are consecutive: their G-word gradient rows are one
    // run of the output, stored coalesced from the staged rows
    const long long base = (long long)(b / Geo::kSamples) * Geo::kSamples * G;
    const long long total = (long long)B * G;
    const int words = Geo::kSamples * G;
    for (int i = lane; i < words; i += 32) {
      const int r = i / G;
      if (base + i < total) grad[base + i] = st.rows[r * st.rstride + (i - r * G)];
    }
  });
}

}  // namespace

#define DQGP_FOR_EACH_N(X) \
  X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8) X(9) X(10)

extern "C" {

// angles points at a (B, G) float32 tensor, gates at the (G, 3) int32 table
// [kind, bit, control bit] (qubit q on bit q for the features, the states
// kernels' map for the states), cot at the cotangent (states = 0: (B, 3n)
// float32 features; states = 1: (B, 2^n) complex64 states), grad at a
// (B, G) float32 tensor. Returns cudaGetLastError().
int dqgp_circuit_vjp(const float* angles, const int* gates, const float* cot, float* grad,
                     int B, int G, int n, int states, int tpb, long long smem_bytes,
                     void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (n) {
#define DQGP_CASE(N)                                                        \
  case N:                                                                   \
    return launch_persistent(warp_vjp_kernel<N>, Geometry<N>::kSamples, B, \
                             tpb, smem_bytes, s, angles, gates, cot, grad,  \
                             B, G, states);
    DQGP_FOR_EACH_N(DQGP_CASE)
#undef DQGP_CASE
  }
  return (int)cudaErrorInvalidValue;
}

// Resident blocks an SM holds of the n-qubit instantiation at this block
// size and shared memory (-1 on error).
int dqgp_circuit_vjp_blocks_per_sm(int n, int tpb, long long smem_bytes) {
  switch (n) {
#define DQGP_CASE(N) \
  case N:            \
    return blocks_per_sm(warp_vjp_kernel<N>, tpb, smem_bytes);
    DQGP_FOR_EACH_N(DQGP_CASE)
#undef DQGP_CASE
  }
  return -1;
}

const char* dqgp_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
