#!/usr/bin/env python
"""Record the JAX references of the port's driver modes.

    JAX_PLATFORMS=cpu python scripts/record_torch_port_driver_modes.py

Writes ``tests/fixtures/torch_port_driver_modes.json`` for ``chip_smoke.py``
phases 13 and 15, from ``dqgp_tpu`` on the CPU in float64:

* ``host_cond``: ``dqgp_tpu.driver.host_condition_numbers`` (each agent's
  float64 Gram from complex128 states, an exact eigvalsh) at the z rows of
  the north-star fixture (``tests/fixtures/torch_port_northstar.json``, 5
  iterations) and of the config #5 fixture
  (``tests/fixtures/torch_port_fidelity.json``, its first 2 iterations),
  over those problems' agent shards. Phase 13 computes the port's values at
  the same rows on the card, through K1's and K2's float64 kernels.
* ``autodiff``: the north-star problem trained for 3 iterations with
  ``grad_method="autodiff"`` on one device (on a multi-device agents mesh
  the JAX package's autodiff gradient is the sum over the mesh's agents),
  with per-iteration 5-fold CV: the z trajectory, CV-NLPD and agent NLLs,
  and iteration 1's exact gradient of every agent (``jax.value_and_grad`` of
  the loss of ``dqgp_tpu/parallel/consensus.py:148-159``) at iteration 1's
  z. Phase 15 trains the port the same way.

chip_smoke.py imports no JAX: on the GPU this file is its reference.
"""

import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from sklearn.model_selection import train_test_split  # noqa: E402

import chip_smoke as cs  # noqa: E402
from dqgp_tpu import driver  # noqa: E402
from dqgp_tpu import manifold as M  # noqa: E402
from dqgp_tpu.data import split_data_numpy  # noqa: E402
from dqgp_tpu.data.synthetic import generate_quantum_gp_data  # noqa: E402
from dqgp_tpu.models.circuits import build_circuit  # noqa: E402
from dqgp_tpu.models.gp.posterior import masked_nll_and_grad  # noqa: E402
from dqgp_tpu.models.kernels import QuantumKernelSpec, gram  # noqa: E402
from dqgp_tpu.parallel.consensus import make_agent_batch  # noqa: E402

OUT = os.path.join(REPO, "tests", "fixtures", "torch_port_driver_modes.json")


def northstar():
    X, Y, X_test, Y_test = cs.make_problem()
    spec = QuantumKernelSpec(
        circuit=build_circuit("chebyshev", cs.NUM_QUBITS, cs.NUM_FEATURES, cs.NUM_LAYERS),
        kernel_type="projected", outer_kernel="matern")
    return spec, X, Y, split_data_numpy(X, Y, cs.N_AGENTS, "regional")


def fidelity_splits():
    """Config #5's shards as scripts/record_torch_port_fidelity.py makes them."""
    spec = QuantumKernelSpec(circuit=build_circuit("kyriienko", cs.FID_QUBITS, 1, cs.FID_LAYERS),
                             kernel_type="fidelity")
    X, Y, _ = generate_quantum_gp_data(cs.FID_SAMPLES, 1, spec, data_seed=cs.FID_SEED,
                                       param_seed=cs.FID_SEED)
    X_tr, _, Y_tr, _ = train_test_split(X, Y, test_size=cs.FID_TEST_SPLIT,
                                        random_state=cs.FID_SEED, shuffle=True)
    return spec, split_data_numpy(X_tr, Y_tr, cs.FID_AGENTS, "regional", 1.0, cs.FID_SEED)


def iteration1_gradient(spec, splits, cfg):
    """Every agent's exact gradient at iteration 1's z (the z update from
    the seeded initial state), as the autodiff step forms it."""
    theta0, psi0, _ = driver.init_admm_state(len(splits), spec.num_parameters, cfg.seed,
                                             cfg.rho, cfg.parity_round)
    z1 = M.round4(M.circular_mean(jnp.asarray(theta0 + psi0 / cfg.rho)))
    batch = make_agent_batch(splits)

    def loss(t, X, Y, mask):
        K = gram(spec, X, t.astype(jnp.float32)).astype(jnp.float64)
        return masked_nll_and_grad(K, jnp.zeros((0,) + K.shape), Y, mask, cfg.noise_std,
                                   compute_cond=False).nll

    vg = jax.jit(jax.vmap(jax.value_and_grad(loss), in_axes=(None, 0, 0, 0)))
    nll, g = vg(M.wrap(z1), batch.X, batch.Y, batch.mask)
    return np.asarray(z1), np.asarray(nll), np.asarray(g)


def record() -> dict:
    spec, X, Y, splits = northstar()
    with open(cs.FIXTURE) as f:
        ns_ref = json.load(f)
    with open(cs.FIDELITY_FIXTURE) as f:
        fid_ref = json.load(f)
    ns_rows = np.array(ns_ref["z_trajectory"])
    fspec, fsplits = fidelity_splits()
    assert [len(x) for x, _ in fsplits] == fid_ref["problem"]["shard_sizes"]
    fid_rows = np.array(fid_ref["z_trajectory"][:cs.COND_FID_ITERS])

    cfg = driver.TrainConfig(max_iter=cs.AUTODIFF_ITERS, grad_method="autodiff",
                             n_mesh_devices=1, verbose=False)
    res = driver.train(spec, splits, X, Y, cfg)
    z1, nll1, g1 = iteration1_gradient(spec, splits, cfg)
    assert np.allclose(z1, res.cv_history[0]["consensus_params"], rtol=0, atol=1e-12)
    assert np.allclose(nll1, res.nll_history[0]["agent_losses"], rtol=1e-10)
    return {
        "about": "JAX references of the port's driver modes "
                 "(scripts/record_torch_port_driver_modes.py)",
        "jax_version": jax.__version__,
        "backend": jax.default_backend(),
        "host_cond": {
            "northstar": {"z_rows": ns_rows.tolist(),
                          "problem_sha256": ns_ref["problem"]["sha256"],
                          "cond": driver.host_condition_numbers(spec, splits, ns_rows).tolist()},
            "fidelity": {"z_rows": fid_rows.tolist(),
                         "x_sha256": fid_ref["problem"]["x_sha256"],
                         "cond": driver.host_condition_numbers(fspec, fsplits, fid_rows).tolist()},
        },
        "autodiff": {
            "problem_sha256": ns_ref["problem"]["sha256"],
            "train_config": {k: v for k, v in vars(cfg).items()
                             if isinstance(v, (int, float, str, bool, type(None)))},
            "iterations": res.iterations,
            "converged_by": res.converged_by,
            "z_trajectory": [h["consensus_params"].tolist() for h in res.cv_history],
            "cv_nlpd": [h["consensus_cv_score"] for h in res.cv_history],
            "agent_nll": [list(map(float, h["agent_losses"])) for h in res.nll_history],
            "iteration1_z": z1.tolist(),
            "iteration1_grad": g1.tolist(),
        },
    }


if __name__ == "__main__":
    data = record()
    with open(OUT, "w") as f:
        json.dump(data, f, indent=1)
        f.write("\n")
    print(f"wrote {OUT}: host cond north star "
          f"{np.array(data['host_cond']['northstar']['cond'])[0].tolist()}, config #5 "
          f"{np.array(data['host_cond']['fidelity']['cond'])[0].tolist()}; autodiff CV-NLPD "
          f"{data['autodiff']['cv_nlpd']}")
