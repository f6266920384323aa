// The fused program on a register-resident state: the body that the fused
// Pauli-feature kernel (K3, pauli_features_fused.cu) and the fused states
// kernel (K4, states_fused.cu) share. K3 is this body plus a reduction, K4
// this body plus a write-out of the state.
//
// Per sample, the body runs the gate-fused op program of
// dqgp_tpu_torch/ops/fusion.py on |0...0>, the state in registers across a
// lane group (warp_state.cuh). It takes the angles: like the TPU functions,
// which build their packed coefficient rows from the angles
// (fusion.packed_inputs) inside the same call, it forms each SU2 op's fused
// 2x2 from its gates' angles itself, in fusion.su2_products' order (each new
// gate multiplied on the left), and reads each phase run's member angles (pi
// for a CZ) straight from the angle row.
//
// Shared memory holds only the tables, the phase-pattern matrix C (permuted
// so that the lanes of a group read consecutive words; from 11 qubits up,
// where C takes 176 KB and more, the kernel derives its columns from the
// members' codes instead, apply_diag_codes, and the warps' exchange slots
// take C's place) and, per warp, its samples' staged rows (angles loaded
// coalesced, at an odd stride, and the SU2 ops' 2x2s, which the lanes of a
// sample build in turn). Blocks are
// persistent: each loads the tables once, then its warps walk the batch a
// warp-sized group of samples at a time, with no barrier after the tables
// are loaded.
//
// Tables (ops/cuda_circuit.py::fused_tables), qubits and controls given as
// the physical bits of the kernel's bit map:
//   op rows [type, qubit, control, first, count, aux]:
//     SU2:  gates [first, first + count) of the gate table, aux = flags
//           (bit 0 real, bit 1 diagonal) | (where its 8 coefficients lie in
//           the staged row) << 2
//     PERM: a CX on qubit (target), control
//     DIAG: its K member angles lie at [first, first + K) of the staged row,
//           aux = first column of C, which is the index of its first member
//   gate table rows [kind, index into the angle row], SU2 gates only;
//   member table: each DIAG member's index into the angle row, -1 for a CZ
//   (its angle is pi); from 11 qubits up followed by each member's code,
//   kind | qubit << 4 | control << 8 (apply_diag_codes).
// A sample's staged row is its G angles, its members' angles and, where the
// sample spans several lanes, its SU2 ops' coefficients (8 an op), which the
// lanes of the sample build between them.

#pragma once

#include <cuda_runtime.h>

#include "warp_state.cuh"

namespace dqgp {
namespace warp {

constexpr int kOpWords = 6;       // [type, qubit, control, first, count, aux]
constexpr int kGateWords = 2;     // [gate kind, gate index]

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

// What a launch hands the body: angles (B, num_gates) float32, C permuted
// (KT, 2^N) as [column][register][lane of the group], the (n_ops, 6),
// (n_gates, 2) and (n_members,) int32 tables.
struct ProgramArgs {
  const float* angles;
  const float* cperm;
  const int* ops;
  const int* gates;
  const int* members;
  int B, num_gates, n_ops, n_gates, n_members, n_su2, KT;
};

// The whole block's work: load the tables, then walk the batch. For each
// sample a lane works on, finish(re, im, lig, b) gets the final state's
// registers of this lane, the lane's index in the sample's group and the
// sample's index b (which may be >= B in the batch's last group: such a
// sample ran on zero angles, and finish must write nothing for it). Every
// lane of the warp calls finish together.
template <int N, typename Finish>
__device__ __forceinline__ void run_fused_batch(const ProgramArgs& p, Finish finish) {
  using Geo = Geometry<N>;
  extern __shared__ __align__(16) float smem_all[];
  float* const smem = smem_all + Exchange<N, float>::kFloats;  // after the exchange slots
  const int B = p.B, num_gates = p.num_gates, n_ops = p.n_ops, n_members = p.n_members;
  const int op_words = kOpWords * n_ops, gate_words = kGateWords * p.n_gates;
  // from 11 qubits up the member table is followed by each member's code
  const int member_words = n_members * (Geo::kW > 1 ? 2 : 1);
  // the tables, then the batch loop's bound and stride
  const int table_words = (op_words + gate_words + member_words + 2 + 3) & ~3;
  const int coef_words = Geo::kL > 1 ? 8 * p.n_su2 : 0;
  const int rstride = (num_gates + n_members + coef_words) | 1;
  int* ops_s = reinterpret_cast<int*>(smem);
  int* gates_s = ops_s + op_words;
  int* members_s = gates_s + gate_words;
  volatile int* loop_s = members_s + member_words;  // [groups, stride]
  float* c_s = smem + table_words;  // [column][register][lane of the group]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // Per warp: its samples' staged rows, then one word that holds the group
  // index across the op loop (so that no register does).
  float* stage = c_s + Geo::kDim * p.KT + warp * (Geo::kSamples * rstride + 1);
  volatile int* group_word = reinterpret_cast<volatile int*>(stage + Geo::kSamples * rstride);

  for (int i = threadIdx.x; i < op_words; i += blockDim.x) ops_s[i] = p.ops[i];
  for (int i = threadIdx.x; i < gate_words; i += blockDim.x) gates_s[i] = p.gates[i];
  for (int i = threadIdx.x; i < member_words; i += blockDim.x) members_s[i] = p.members[i];
  if (threadIdx.x == 0) {
    loop_s[0] = (B + Geo::kSamples - 1) / Geo::kSamples;
    loop_s[1] = gridDim.x * (blockDim.x >> 5) / Geo::kW;  // groups of kW warps
  }
  for (int i = threadIdx.x; i < Geo::kDim * p.KT; i += blockDim.x) c_s[i] = p.cperm[i];
  __syncthreads();

  // lane within the sample's group (from 11 qubits up, over its warps)
  const int lig = (lane & (Geo::kL - 1)) + (Geo::kW > 1 ? warp % Geo::kW * 32 : 0);
  const int sw = lane / Geo::kL;         // the warp's sample this lane works on
  float* row = stage + sw * rstride;
  // Nothing of the batch loop stays live across the op loop beside the
  // state: the group index, the loop's bound and its stride wait in shared
  // memory (volatile words, so the compiler reloads them), and which of the
  // group's samples exist (s0 + s < B) is tested where it is needed. Each of
  // a group's warps stages its own copy of the group's row and builds its
  // own 2x2s.
  for (int g = (blockIdx.x * (blockDim.x >> 5) + warp) / Geo::kW; g < loop_s[0];) {
    const int s0 = g * Geo::kSamples;
    __syncwarp();
    if (lane == 0) *group_word = g;
    for (int s = 0; s < Geo::kSamples; ++s) {
      const bool here = s0 + s < B;
      const float* src = p.angles + (long long)(s0 + s) * num_gates;
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
        // (from 11 qubits up each warp of the sample builds them all)
        if (op[0] != OP_SU2 || ((at >> 3) & (Geo::kL - 1)) != (Geo::kW > 1 ? lane : lig))
          continue;
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
      } else if constexpr (Geo::kW > 1) {  // C's columns from the members' codes
        const float* a = row + first;
        apply_diag_codes<N>(re, im, members_s + n_members + aux, count, lig,
                            [a](int j) { return a[j]; });
      } else {
        const float* a = row + first;
        apply_diag<N>(re, im, c_s + aux * Geo::kDim + lig, count,
                      [a](int j) { return a[j]; });
      }
    }

    g = *group_word;
    finish(re, im, lig, g * Geo::kSamples + sw);
    g += loop_s[1];
  }
}

}  // namespace warp
}  // namespace dqgp
