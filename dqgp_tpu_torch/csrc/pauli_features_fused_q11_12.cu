// K3's instantiations at 11 and 12 qubits, a sample's state across 2 and 4
// warps: the kernel and the interface of pauli_features_fused.cu, built as a
// translation unit of their own so that nvcc compiles them beside the
// 1-10-qubit instantiations, in parallel.

#define DQGP_QUBITS(X) X(11) X(12)

#include "pauli_features_fused.cu"
