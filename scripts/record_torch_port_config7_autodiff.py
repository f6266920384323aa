#!/usr/bin/env python
"""Record the JAX reference for the port's config #7 autodiff run.

    JAX_PLATFORMS=cpu python scripts/record_torch_port_config7_autodiff.py

The config #7 fixture problem of ``scripts/record_torch_port_config7.py``
(full width: chebyshev 10 qubits / 2 layers, projected Matérn, rho = L =
100, noise 0.1, CV on a 512-row subsample, ``compute_cond=False``; cut
depth: 1,111 samples, 999 training rows over 8 regional agents) trained by
``dqgp_tpu.driver.train`` for ``chip_smoke.C7_FIX_ITERS`` iterations with
``grad_method="autodiff"`` on one device (``n_mesh_devices=1``: on a
multi-device agents mesh the JAX package's autodiff gradient is the sum
over the mesh's agents). Its step differentiates the NLL at wrap(z)
through the XLA statevector engine (dqgp_tpu/parallel/consensus.py:
145-160). Writes ``tests/fixtures/torch_port_config7_autodiff.json``: the
problem's digests, the z trajectory, every iteration's agent NLLs, the
CV-NLPD, iteration 1's z and every agent's exact gradient there
(``jax.value_and_grad`` of the step's loss), and the same agent NLLs
re-scored at the same z from float64 features, the eager float32 engine and
the float32 gate-fused program (the one K3 runs), so that the fixture
carries the JAX package's own spread there, as the streamed fixture does;
likewise iteration 1's gradient from float64 features and from the
float32 gate-fused program.
chip_smoke.py imports no JAX: on the GPU this file is its reference.
"""

import json
import os
import sys
import time
from unittest import mock

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
from dqgp_tpu.data.synthetic import generate_data_numpy  # noqa: E402
from dqgp_tpu.models.circuits import build_circuit  # noqa: E402
from dqgp_tpu.models.kernels import QuantumKernelSpec  # noqa: E402
from dqgp_tpu.models.kernels import quantum_kernel as jqk  # noqa: E402
from scripts.record_torch_port_config7 import agent_nll_at, fused_program_features  # noqa: E402
from scripts.record_torch_port_driver_modes import iteration1_gradient  # noqa: E402

OUT = os.path.join(REPO, "tests", "fixtures", "torch_port_config7_autodiff.json")


def problem():
    spec = QuantumKernelSpec(circuit=build_circuit("chebyshev", cs.C7_QUBITS, 2, cs.C7_LAYERS),
                             kernel_type="projected", outer_kernel="matern")
    X, Y = generate_data_numpy(cs.C7_FIX_SAMPLES, 2, 0.1, cs.C7_SEED)
    X_tr, _, Y_tr, _ = train_test_split(X, Y, test_size=cs.C7_TEST_SPLIT,
                                        random_state=cs.C7_SEED, shuffle=True)
    splits = split_data_numpy(X_tr, Y_tr, cs.C7_FIX_AGENTS, "regional", 1.0, cs.C7_SEED)
    return spec, X, Y, X_tr, Y_tr, splits


def record() -> dict:
    spec, X, Y, X_tr, Y_tr, splits = problem()
    cfg = driver.TrainConfig(max_iter=cs.C7_FIX_ITERS, seed=cs.C7_SEED,
                             grad_method="autodiff", cv_max_samples=cs.C7_CV_MAX,
                             compute_cond=False, n_mesh_devices=1, verbose=False)
    t0 = time.time()
    res = driver.train(spec, splits, X_tr, Y_tr, cfg)
    train_s = time.time() - t0
    z_traj = [np.asarray(h["consensus_params"]) for h in res.cv_history]
    z1, nll1, g1 = iteration1_gradient(spec, splits, cfg)
    assert np.allclose(z1, z_traj[0], rtol=0, atol=1e-12)
    assert np.allclose(nll1, res.nll_history[0]["agent_losses"], rtol=1e-10)
    with fused_program_features():
        fused_nll = agent_nll_at(spec, splits, z_traj)
        g1_fused = iteration1_gradient(spec, splits, cfg)[2]
    features = jqk.kernel_features
    with mock.patch.object(jqk, "kernel_features",
                           lambda spec, X, theta, dtype=None: features(spec, X, theta,
                                                                       jnp.float64)):
        g1_f64 = iteration1_gradient(spec, splits, cfg)[2]
    return {
        "about": "JAX reference for the PyTorch port's config #7 autodiff run "
                 "(scripts/record_torch_port_config7_autodiff.py)",
        "jax_version": jax.__version__,
        "backend": jax.default_backend(),
        "jax_train_seconds": train_s,
        "problem": {
            "source": "BASELINE.md:41 config #7 at full width, 1111 samples over 8 "
                      "agents; cli.py:342-378 classical data flow",
            "n_samples": cs.C7_FIX_SAMPLES, "test_split": cs.C7_TEST_SPLIT,
            "agents": cs.C7_FIX_AGENTS, "seed": cs.C7_SEED,
            "encoding": "chebyshev", "num_qubits": cs.C7_QUBITS,
            "num_layers": cs.C7_LAYERS, "kernel": "projected", "outer_kernel": "matern",
            "x_sha256": cs.array_digest(X), "y_sha256": cs.array_digest(Y),
            "shard_sizes": [int(x.shape[0]) for x, _ in splits],
        },
        "train_config": {k: v for k, v in vars(cfg).items()
                         if isinstance(v, (int, float, str, bool, type(None)))},
        "iterations": res.iterations,
        "converged_by": res.converged_by,
        "z_trajectory": [z.tolist() for z in z_traj],
        "agent_nll": [list(map(float, h["agent_losses"])) for h in res.nll_history],
        "cv_nlpd": [h["consensus_cv_score"] for h in res.cv_history],
        "iteration1_z": z1.tolist(),
        "iteration1_grad": g1.tolist(),
        "iteration1_grad_f64_features": g1_f64.tolist(),
        "iteration1_grad_fused_f32": g1_fused.tolist(),
        "agent_nll_f64_features": agent_nll_at(spec, splits, z_traj, jnp.float64),
        "agent_nll_eager_f32": agent_nll_at(spec, splits, z_traj),
        "agent_nll_fused_f32": fused_nll,
    }


if __name__ == "__main__":
    data = record()
    with open(OUT, "w") as f:
        json.dump(data, f, indent=1)
        f.write("\n")
    g = np.array(data["iteration1_grad"])
    spread = {k: float(np.abs(np.array(data[k]) - g).max() / np.abs(g).max())
              for k in ("iteration1_grad_f64_features", "iteration1_grad_fused_f32")}
    print(f"wrote {OUT}: {data['iterations']} iterations in {data['jax_train_seconds']:.1f} s, "
          f"nll_sum {[round(sum(r), 4) for r in data['agent_nll']]}, CV-NLPD "
          f"{data['cv_nlpd']}, iteration 1 max |g| {np.abs(g).max():.4f}, JAX's own gradient "
          f"spread (of max |g|) {spread}")
