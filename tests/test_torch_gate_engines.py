"""Where the north star's 25-iteration run leaves the JAX trajectory: the
two packages' float32 engines, or the port's float64 GP/ADMM side?

The port's own ``driver.train`` runs the north star (chip_smoke.py's
problem) against the JAX float64-GP run of 25 iterations
(tests/fixtures/torch_port_northstar_25.json), with the float32 part of the
computation taken from the JAX package through a test-only seam. The
float64 side (solves, NLL, gradient, ADMM updates, 4-dp rounding, CV) stays
the port's.

* ``features``: the (X, theta) -> features seam, which takes in
  ``angle_matrix`` (``quantum_kernel.angle_matrix`` and
  ``features_from_angles``, through which both the step's shifted Grams and
  the CV pass go), runs JAX's ``angle_matrix`` and ``features_from_angles``
  on numpy copies. The features are then bit for bit JAX's, but the step
  still forms its float32 Matérn Gram pair with torch. That run holds the
  gate's bars for the iterations the card holds (``GATE_HELD_ITERS``) and
  no further. Torch's float32 Matérn Gram differs from XLA's in the last
  ulps on identical features (at iteration 1's wrap(z): 71 % of the
  entries, by up to 2.5e-6; the matmul form of the squared distance
  cancels, and its rounding follows the summation order), and even XLA's
  own differs between two compilations of the JAX package's functions
  (``gram_from_features`` vmapped, against ``gram_and_shift_grads`` jitted
  over the agents: 19 % of the entries by one ulp). 4-dp roundings flip
  from iteration 2 and the run forks at iteration 8 (z[6] by 3.03), as it
  does with the port's own features.
* ``grams``: in addition, the step's (X, theta) -> (K, dK) seam
  (``consensus.gram_and_shift_grads``) runs JAX's ``gram_and_shift_grads``
  jitted over the agents, as JAX's step runs it. The port's float64 side
  then follows JAX's run for all 25 iterations: z identical at every
  iteration, CV-NLPD within 1e-9.

So the fork is the float32 Gram's last ulps, not a fault of the port's
solver. ``PYTHONPATH=. python tests/test_torch_gate_engines.py`` prints each seam's
deviations over the 25 iterations.
"""

import contextlib
import io
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
from dqgp_tpu.models.circuits import build_circuit as jax_build_circuit
from dqgp_tpu.models.kernels import quantum_kernel as JQ
from dqgp_tpu.ops import statevector as JS
from dqgp_tpu_torch import driver as TD
from dqgp_tpu_torch.data import split_data_numpy
from dqgp_tpu_torch.models.circuits import build_circuit
from dqgp_tpu_torch.models.kernels import QuantumKernelSpec
from dqgp_tpu_torch.models.kernels import quantum_kernel as TQ
from dqgp_tpu_torch.parallel import consensus as TC
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

SEAMS = ("features", "grams")


def _jax_seams():
    """The JAX package's float32 functions behind each seam, jitted once."""
    spec = JQ.QuantumKernelSpec(
        circuit=jax_build_circuit("chebyshev", cs.NUM_QUBITS, cs.NUM_FEATURES, cs.NUM_LAYERS),
        kernel_type="projected", outer_kernel="matern")
    angles = jax.jit(jax.vmap(lambda x, t: JS.angle_matrix(spec.circuit, x, t, jnp.float32)))
    features = jax.jit(lambda a: JQ.features_from_angles(spec, a))
    grams = jax.jit(jax.vmap(lambda x, t, h: JQ.gram_and_shift_grads(spec, x, t, h),
                             in_axes=(0, None, None)), static_argnums=2)
    return angles, features, grams


def install_seam(seam: str, monkeypatch) -> dict:
    """Route the port's float32 functions behind ``seam`` to the JAX
    package's (for the north star's circuit and kernel); float64 calls (the
    host condition numbers, the noise fit) stay the port's. Returns the
    seams' float32 call counts, which the calls update."""
    jax_angles, jax_features, jax_grams = _jax_seams()
    calls = dict.fromkeys(("angle_matrix", "features_from_angles", "gram_and_shift_grads"), 0)
    port_angle_matrix, port_features = TQ.angle_matrix, TQ.features_from_angles

    def angle_matrix(circuit, X, theta, dtype=torch.float32):
        if dtype == torch.float64:
            return port_angle_matrix(circuit, X, theta, dtype)
        assert dtype == torch.float32
        calls["angle_matrix"] += 1
        Xn, Tn = X.detach().numpy(), theta.detach().numpy()
        lead = np.broadcast_shapes(Xn.shape[:-2], Tn.shape[:-1])
        Xb = np.broadcast_to(Xn, lead + Xn.shape[-2:]).reshape(-1, *Xn.shape[-2:])
        Tb = np.broadcast_to(Tn, lead + Tn.shape[-1:]).reshape(-1, Tn.shape[-1])
        out = np.array(jax_angles(Xb, Tb))
        return torch.from_numpy(out.reshape(lead + out.shape[-2:]))

    def features_from_angles(spec, angles):
        if angles.dtype == torch.float64:
            return port_features(spec, angles)
        calls["features_from_angles"] += 1
        return torch.from_numpy(np.array(jax_features(angles.detach().numpy())))

    def gram_and_shift_grads(spec, X, theta, h=float(np.pi / 8)):
        assert X.dim() == 3 and theta.dtype == torch.float32
        calls["gram_and_shift_grads"] += 1
        K, dK = jax_grams(X.numpy(), theta.numpy(), float(h))
        return torch.from_numpy(np.array(K)), torch.from_numpy(np.array(dK))

    monkeypatch.setattr(TQ, "angle_matrix", angle_matrix)
    monkeypatch.setattr(TQ, "features_from_angles", features_from_angles)
    if seam == "grams":
        monkeypatch.setattr(TC, "gram_and_shift_grads", gram_and_shift_grads)
    return calls


def run_with_seam(seam: str, iters: int, monkeypatch):
    """The port's north-star ``train`` on the CPU for ``iters`` iterations
    with ``seam``'s float32 functions from the JAX package. Returns (z
    trajectory, CV-NLPD, the seams' call counts)."""
    calls = install_seam(seam, monkeypatch)
    X, Y, _, _ = cs.make_problem()
    spec = QuantumKernelSpec(
        circuit=build_circuit("chebyshev", cs.NUM_QUBITS, cs.NUM_FEATURES, cs.NUM_LAYERS),
        kernel_type="projected", outer_kernel="matern")
    with contextlib.redirect_stdout(io.StringIO()):
        splits = split_data_numpy(X, Y, cs.N_AGENTS, "regional")
    res = TD.train(spec, splits, X, Y, TD.TrainConfig(max_iter=iters, verbose=False),
                   device="cpu")
    z = np.array([h["consensus_params"] for h in res.cv_history])
    cv = np.array([h["consensus_cv_score"] for h in res.cv_history])
    return z, cv, calls


def _reference():
    with open(cs.FIXTURE_25) as f:
        return json.load(f)


@pytest.mark.parametrize("seam", SEAMS)
def test_port_float64_side_follows_jax_given_its_float32_engines(seam, monkeypatch):
    iters = cs.GATE_HELD_ITERS if seam == "features" else cs.GATE_ITERS
    z, cv, calls = run_with_seam(seam, iters, monkeypatch)
    ref = _reference()
    # every step and every CV pass went through the seam
    if seam == "features":
        assert calls["angle_matrix"] == calls["features_from_angles"] == 2 * iters
    else:
        assert calls["gram_and_shift_grads"] == iters
        assert calls["angle_matrix"] == calls["features_from_angles"] == iters
    z_dev, cv_dev, held, first = cs.gate_deviations(z, cv, ref)
    assert held == iters and first is None, (seam, first)
    assert z_dev.max() <= cs.Z_TOL and cv_dev.max() <= cs.NLPD_TOL
    if seam == "grams":
        # the float64 side is the JAX package's, step for step
        np.testing.assert_array_equal(z, np.array(ref["z_trajectory"]))
        np.testing.assert_allclose(cv, ref["cv_nlpd"], rtol=0, atol=1e-9)


def gram_differences():
    """At the run's first z: every agent's float32 Gram at wrap(z) from
    JAX's features, formed by torch's Matérn
    (the port's) and by a second XLA compilation (``gram_from_features``
    vmapped over the shifts), each against JAX's ``gram_and_shift_grads``
    jitted over the agents: (largest |diff|, share of entries that
    differ) of each."""
    jax_angles, jax_features, jax_grams = _jax_seams()
    X, Y, _, _ = cs.make_problem()
    with contextlib.redirect_stdout(io.StringIO()):
        splits = split_data_numpy(X, Y, cs.N_AGENTS, "regional")
    Xb = TC.make_agent_batch(splits, "cpu").X.numpy()
    theta, psi, _ = TD.init_admm_state(cs.N_AGENTS, 40, 42, 100.0)
    from dqgp_tpu_torch import manifold as TM
    xi = torch.as_tensor(theta + psi / 100.0)
    phase = 2.0 * np.pi * xi / TM.PERIOD
    z = TM.round4(TM.circular_mean_from_sums(torch.cos(phase).sum(0), torch.sin(phase).sum(0)))
    t = TM.wrap(z).to(torch.float32)
    shifts = TQ.shift_parameter_batch(t, float(np.pi / 8)).numpy()       # (S, P)
    K, _ = jax_grams(Xb, t.numpy(), float(np.pi / 8))
    S, (A, N, _) = shifts.shape[0], Xb.shape
    a = jax_angles(np.repeat(Xb, S, axis=0), np.tile(shifts, (A, 1)))
    F = np.array(jax_features(np.asarray(a).reshape(-1, a.shape[-1]))).reshape(A, S, N, -1)
    spec_t = QuantumKernelSpec(
        circuit=build_circuit("chebyshev", cs.NUM_QUBITS, cs.NUM_FEATURES, cs.NUM_LAYERS),
        kernel_type="projected", outer_kernel="matern")
    spec_j = JQ.QuantumKernelSpec(
        circuit=jax_build_circuit("chebyshev", cs.NUM_QUBITS, cs.NUM_FEATURES, cs.NUM_LAYERS),
        kernel_type="projected", outer_kernel="matern")
    torch_k = TQ.gram_from_features(spec_t, torch.from_numpy(F)).numpy()[:, 0]
    xla = jax.jit(jax.vmap(jax.vmap(lambda f: JQ.gram_from_features(spec_j, f))))
    xla_k = np.array(xla(F))[:, 0]
    K = np.array(K)
    return {name: (float(np.abs(k - K).max()), float((k != K).mean()))
            for name, k in (("torch", torch_k), ("xla", xla_k))}


if __name__ == "__main__":
    ref = _reference()
    print("the float32 Gram at wrap(z) of iteration 1 from JAX's features, against "
          "JAX's step's (largest |diff|, share that differ):", gram_differences())
    for seam in SEAMS:
        with pytest.MonkeyPatch.context() as mp:
            t0 = time.time()
            z, cv, _ = run_with_seam(seam, cs.GATE_ITERS, mp)
        z_dev, cv_dev, held, first = cs.gate_deviations(z, cv, ref)
        print(f"{seam} ({time.time() - t0:.1f} s): held {held} iterations, first departure "
              f"{first}; z dev by iteration {np.round(z_dev, 4).tolist()}; CV-NLPD dev "
              f"{[float(f'{v:.2e}') for v in cv_dev]}")
