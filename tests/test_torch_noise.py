"""The port's marginal-likelihood noise fit (``dqgp_tpu_torch/models/gp/noise.py``)
against the JAX package's (``dqgp_tpu/models/gp/noise.py``) at the same theta.

Both build the noise-free training Gram in float64 (the port on the CPU
through its plain complex128 engine, JAX through its jitted float64 Gram)
and decompose it (torch's eigh, numpy's); the grid and the golden-section
refinement are the same code. Bars: sigma rtol 1e-6, every NMLL value rtol
1e-9, the grid identical.
"""

import numpy as np
import pytest
import torch

from dqgp_tpu.data import generate_quantum_gp_data as jax_generate
from dqgp_tpu.models.circuits import build_circuit as jax_build_circuit
from dqgp_tpu.models.gp import fit_noise_std as jax_fit
from dqgp_tpu.models.kernels import QuantumKernelSpec as JaxSpec
from dqgp_tpu_torch.convert import spec_from_jax
from dqgp_tpu_torch.models.gp import NoiseFitResult, fit_noise_std
from dqgp_tpu_torch.models.kernels.quantum_kernel import gram
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

SPECS = {
    "projected": dict(encoding="hubregtsen", qubits=2, layers=1, kernel_type="projected",
                      outer_kernel="matern"),
    "projected_chebyshev": dict(encoding="chebyshev", qubits=3, layers=2,
                                kernel_type="projected", outer_kernel="gaussian"),
    "fidelity": dict(encoding="kyriienko", qubits=3, layers=1, kernel_type="fidelity",
                     outer_kernel="gaussian"),
}


def _problem(kind, n=120, sigma=0.3, seed=11):
    s = SPECS[kind]
    spec = JaxSpec(circuit=jax_build_circuit(s["encoding"], s["qubits"], 1, s["layers"]),
                   kernel_type=s["kernel_type"], outer_kernel=s["outer_kernel"])
    X, Y, theta = jax_generate(num_samples=n, input_dim=1, spec=spec, noise_std=sigma,
                               data_seed=seed)
    return spec, X, Y, theta


def _same_fit(got: NoiseFitResult, want):
    np.testing.assert_allclose(got.noise_std, want.noise_std, rtol=1e-6)
    np.testing.assert_allclose(got.nmll, want.nmll, rtol=1e-9)
    np.testing.assert_allclose(got.nmll_at_input, want.nmll_at_input, rtol=1e-9)
    np.testing.assert_array_equal(got.grid_sigma, want.grid_sigma)
    np.testing.assert_allclose(got.grid_nmll, want.grid_nmll, rtol=1e-9)


@pytest.mark.parametrize("kind", sorted(SPECS))
@pytest.mark.parametrize("sigma,current", [(0.3, 0.1), (0.05, 0.5)])
def test_fit_matches_jax(kind, sigma, current):
    spec, X, Y, theta = _problem(kind, sigma=sigma)
    want = jax_fit(spec, X, Y, theta, current_noise_std=current)
    got = fit_noise_std(spec_from_jax(spec), X, Y, theta, current_noise_std=current,
                        device="cpu")
    _same_fit(got, want)
    assert got.nmll <= got.nmll_at_input


def test_fit_options_match_jax():
    spec, X, Y, theta = _problem("projected", n=60, sigma=0.8, seed=12)
    kw = dict(current_noise_std=0.2, jitter=1e-5, bounds=(1e-2, 2.0), grid_points=17)
    _same_fit(fit_noise_std(spec_from_jax(spec), X, Y, theta, device="cpu", **kw),
              jax_fit(spec, X, Y, theta, **kw))


def test_precomputed_gram_matches():
    """A caller's K (numpy or tensor) gives the fit of the Gram built
    inside, and JAX's fit on the same K."""
    spec, X, Y, theta = _problem("projected", n=80, sigma=0.2, seed=13)
    tspec = spec_from_jax(spec)
    K = gram(tspec, torch.tensor(X), torch.tensor(theta), dtype=torch.float64)
    inside = fit_noise_std(tspec, X, Y, theta, device="cpu")
    for k in (K, K.numpy()):
        got = fit_noise_std(tspec, X, Y, theta, K=k, device="cpu")
        assert got.noise_std == inside.noise_std
        np.testing.assert_array_equal(got.grid_nmll, inside.grid_nmll)
    _same_fit(fit_noise_std(tspec, X, Y, theta, K=K, device="cpu"),
              jax_fit(spec, X, Y, theta, K=K.numpy()))


def test_fit_recovers_the_generating_noise():
    """At the generating parameters the optimum lands near sigma (N=300:
    the estimator's stderr is ~sigma/sqrt(2N) ~ 4%), as the JAX package's
    own test holds it."""
    spec, X, Y, theta = _problem("projected", n=300, sigma=0.3, seed=11)
    fit = fit_noise_std(spec_from_jax(spec), X, Y, theta, current_noise_std=0.1, device="cpu")
    assert abs(fit.noise_std - 0.3) / 0.3 < 0.25
    assert fit.nmll <= fit.nmll_at_input
