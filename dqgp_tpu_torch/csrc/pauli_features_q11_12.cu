// K1's float32 instantiations at 11 and 12 qubits, a sample's state across 2
// and 4 warps: the kernels and the interface of pauli_features.cu, built as a
// translation unit of their own so that nvcc compiles them beside the 1-10-qubit
// instantiations, in parallel.

#define DQGP_F32_QUBITS(X) X(11) X(12)
#define DQGP_F64_QUBITS(X)

#include "pauli_features.cu"
