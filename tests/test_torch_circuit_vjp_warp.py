"""The adjoint kernel's register layout (csrc/circuit_vjp.cu) as far as the
CPU reaches it: its launch geometry, and a plain numpy model of its walk over
the lane/register split of csrc/warp_state.cuh.

The model holds a sample's two states, phi and lambda, as the kernel does:
[lane][register], physical bits 0..4 of an amplitude's index on the
register, bits 5.. on the lane. It runs the forward gate sequence through
the split of tests/test_torch_states_warp.py's model, seeds lambda as the
kernel's seed_features (2 O psi, a lane qubit's pairs with the partner lane
lig ^ m, as __shfl_xor_sync exchanges them) or seed_states (the state's
cotangent read in K2's map: amplitude k is register k >> (n-5) of lane
k & (L-1)) does, then walks the gates backwards: each rotation's lane
partial of Im <lambda|P|phi> (a register target pairs register r with
r ^ 2^q, a lane target takes the partner lane's phi, a diagonal generator
needs neither), kept for every lane and gate, then the inverse gate on
both states; after the walk a sample's gradients are its lanes' partials
summed. Under the features map qubit q is bit q (K1's table); under
the states map the gate table is K2's.

The model runs in complex128, where the split is exact, and is held to
``torch.autograd`` through the plain engine (``circuit_vjp_reference``) at
1e-10 of max(1, max |g|) on circuits with all ten gate kinds, for every
qubit count the kernel is built for (lane bits from 6 qubits) and both
outputs. The kernel itself, in float32, is held to the same plain version
within 5e-5 of max(1, max |g|) on the card (chip_smoke.py phase 15a,
tests/test_torch_cuda.py).
"""

import numpy as np
import pytest
import torch

from test_torch_circuit_vjp import all_kinds_circuit
from test_torch_states_warp import (
    LaneRegisterState, _every_kind_circuit, _gate_2x2, _model_gate_sequence,
)
from dqgp_tpu_torch.models.circuits import ENCODING_TYPES, build_circuit
from dqgp_tpu_torch.ops import circuit as tc
from dqgp_tpu_torch.ops import cuda_circuit as K
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

MODEL_TOL = 1e-10


def _circuit(n, seed):
    """All ten gate kinds (the two-qubit ones from 2 qubits), targets and
    controls on seeded qubits: from 6 qubits on register and lane bits."""
    return all_kinds_circuit(n, seed) if n < 2 else _every_kind_circuit(n, seed)


class WarpVjpModel:
    """One launch of the adjoint kernel over a batch, in the model."""

    def __init__(self, circuit, angles, cot, output):
        self.states_layout = output == "states"
        self.table = K.gate_table(circuit, self.states_layout).tolist()
        self.angles = angles
        self.phi = _model_gate_sequence(circuit, angles, self.states_layout)
        self.lam = LaneRegisterState(circuit.num_qubits, angles.shape[0])
        self.n, self.A, self.L = circuit.num_qubits, self.phi.A, self.phi.L
        self.lig, self.reg = self.phi.lig, self.phi.reg
        if self.states_layout:
            self._seed_states(cot)
        else:
            self._seed_features(cot)

    def _seed_features(self, cot):
        """lambda = 2 (gx X_q + gy Y_q + gz Z_q) phi summed over q, qubit q
        on bit q: a register qubit's pairs inside the lane, a lane qubit's
        with the partner lane (Y phi = -i phi' where the lane's bit is
        clear, +i phi' where it is set; Z phi = -phi where set)."""
        n, p = self.n, self.phi.s
        lam = np.zeros_like(p)
        for q in range(n):
            gx, gy, gz = (2.0 * cot[:, j * n + q, None, None] for j in range(3))
            if q < self.phi.reg_bits:
                for pair in range(self.A // 2):
                    k0 = ((pair >> q) << (q + 1)) | (pair & ((1 << q) - 1))
                    k1 = k0 | (1 << q)
                    p0, p1 = p[:, :, k0, None], p[:, :, k1, None]
                    lam[:, :, [k0]] += gx * p1 - 1j * gy * p1 + gz * p0
                    lam[:, :, [k1]] += gx * p0 + 1j * gy * p0 - gz * p1
            else:
                m = 1 << (q - 5)
                partner = p[:, self.lig ^ m, :]
                hi = ((self.lig & m) != 0)[None, :, None]
                ys, zs = np.where(hi, -gy, gy), np.where(hi, -gz, gz)
                lam += gx * partner - 1j * ys * partner + zs * p
        self.lam.s = lam

    def _seed_states(self, cot):
        """lambda[lane l][register r] = cot[r L + l]."""
        for l in range(self.L):
            for r in range(self.A):
                self.lam.s[:, l, r] = cot[:, r * self.L + l]

    def _generator_partial(self, kind, q, ctl):
        """(rows, L): each lane's partial of Im <lambda|P|phi>."""
        p, lam = self.phi.s, self.lam.s
        if kind in (tc.RZ, tc.CRZ, tc.RZZ):
            one_q = self.phi._bit(q)
            minus = one_q != self.phi._bit(ctl) if kind == tc.RZZ else one_q
            ok = self.phi._control(-1 if kind == tc.RZZ else ctl)
            t = np.imag(np.conj(lam) * p)
            return np.where(ok[None], np.where(minus[None], -t, t), 0.0).sum(-1)
        ok = self.phi._control(ctl)
        if q < 5:  # the pair's other amplitude in this lane's registers
            other = p[:, :, self.reg ^ (1 << q)]
            bit = ((self.reg >> q) & 1).astype(bool)[None, None, :]
        else:      # in the partner lane, same register
            m = 1 << (q - 5)
            other = p[:, self.lig ^ m, :]
            bit = ((self.lig & m) != 0)[None, :, None]
        if kind in (tc.RY, tc.CRY):  # (Y phi)_k = -i phi' (bit clear), +i phi' (set)
            t = np.where(bit, 1.0, -1.0) * np.real(np.conj(lam) * other)
        else:                        # (X phi)_k = phi'
            t = np.imag(np.conj(lam) * other)
        return np.where(ok[None], t, 0.0).sum(-1)

    def _undo(self, kind, q, ctl, half):
        """U^H = U(-a) on both states; H, CX and CZ are their own inverses."""
        for st in (self.phi, self.lam):
            if kind == tc.CX:
                st.perm(q, ctl)
            elif kind in (tc.CZ, tc.RZZ):
                st.diag2(q, ctl, kind == tc.CZ, -half)
            else:
                st.su2(_gate_2x2(kind, -half), q, ctl)

    def run(self):
        """The backward walk; each lane's partial of every gate kept, and a
        sample's gradients summed over its lanes once after the walk."""
        rows, G = self.angles.shape
        parts = np.full((rows, self.L, G), np.nan)
        for j in reversed(range(G)):
            kind, q, ctl = self.table[j]
            parts[:, :, j] = 0.0
            if kind not in (tc.H, tc.CX, tc.CZ):
                parts[:, :, j] = self._generator_partial(kind, q, ctl)
            if j > 0:
                self._undo(kind, q, ctl, 0.5 * self.angles[:, j])
        grad = np.zeros((rows, G))
        for lane in range(self.L):
            grad += parts[:, lane, :]
        return 0.5 * grad


def _cotangent(rng, circuit, rows, output):
    if output == "features":
        return rng.uniform(-1, 1, (rows, 3 * circuit.num_qubits))
    return rng.randn(rows, circuit.dim) + 1j * rng.randn(rows, circuit.dim)


@pytest.mark.parametrize("output", K.VJP_OUTPUTS)
@pytest.mark.parametrize("n", range(1, K.ONE_WARP_QUBITS + 1))
def test_warp_model_of_the_adjoint_matches_autograd(n, output):
    c = _circuit(n, seed=n)
    kinds = {g.kind for g in c.gates}
    assert kinds == (set(range(10)) if n > 1 else {tc.RX, tc.RY, tc.RZ, tc.H})
    if n > 6:  # targets and controls on both sides of the register/lane split
        assert {g.qubit >= 5 for g in c.gates} == {True, False}
        assert {g.control >= 5 for g in c.gates if g.control >= 0} == {True, False}
    rng = np.random.RandomState(50 + n)
    rows = 2
    angles = rng.uniform(-np.pi, 3 * np.pi, (rows, c.num_gates))
    cot = _cotangent(rng, c, rows, output)
    want = K.circuit_vjp_reference(c, torch.as_tensor(angles), torch.as_tensor(cot),
                                   output).numpy()
    got = WarpVjpModel(c, angles, cot, output).run()
    np.testing.assert_allclose(got, want, rtol=0, atol=MODEL_TOL * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("n", range(1, K.ONE_WARP_QUBITS + 1))
def test_adjoint_warp_geometry(n):
    """K1's shared-memory layout (the (G, 3) gate table and each warp's
    staged rows, which take the gradient in place of the angles) and, where
    a sample spans lanes, each lane's G partial gradients; one block an SM
    from 5 qubits, where the two states are 128 registers a lane, two
    below; 128-thread blocks up to 5 qubits, as K1's."""
    for enc in ENCODING_TYPES:
        c = build_circuit(enc, n, 2, 2)
        G = c.num_gates
        geo = K.vjp_geometry(c)
        lanes = max(1, 2 ** (n - 5))
        assert geo.lanes == lanes and geo.samples == geo.threads // lanes and geo.c_bytes == 0
        assert geo.threads == (128 if n <= 5 else 256)
        table = 4 * ((3 * G + 2 + 3) // 4 * 4)
        partials = 32 * (G | 1) if n > 5 else 0  # every lane's partial gradients
        per_warp = 4 * ((32 // lanes) * (G | 1) + 1 + partials)
        assert geo.smem_bytes == table + geo.threads // 32 * per_warp
        assert K.vjp_min_blocks(n) * geo.smem_bytes <= 224 * 1024
    assert K.vjp_min_blocks(n) == (2 if n <= 4 else 1)
