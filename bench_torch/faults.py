"""Faults planted under the timed path, and the controls, for the checks'
calibration (``calibrate.py``) and the CPU tests. The benchmark's own runs
use none of this.

Each fault is a context manager that patches the program while it is open:

* ``unchanged``: the step returns its state unchanged (theta and psi
  as they came in; the CG's solution stays at its start);
* ``half``: half of the batch left out, the mean taken over the rest (each
  agent's second half of rows masked out; the posterior's second half of
  training rows dropped);
* ``altered``: an answer altered where it is produced (the features one
  part in a thousand off; the posterior mean off by a hundredth).

Cells on one card have no exchange between chips to leave out.
"""

from __future__ import annotations

import contextlib

import torch

FAULTS = ("unchanged", "half", "altered")


@contextlib.contextmanager
def _patch(module, name, value):
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


@contextlib.contextmanager
def train_fault(kind: str):
    import dqgp_tpu_torch.driver as driver
    import dqgp_tpu_torch.models.kernels.quantum_kernel as qk
    import dqgp_tpu_torch.parallel.consensus as consensus

    if kind == "unchanged":
        real = consensus.admm_iteration

        def still(spec, theta, psi, batch, **kw):
            out = real(spec, theta, psi, batch, **kw)
            return out._replace(theta=theta.clone(), psi=psi.clone())

        with _patch(consensus, "admm_iteration", still):
            yield
    elif kind == "half":
        real = driver.make_agent_batch

        def half(splits, device, pad_to=None):
            b = real(splits, device, pad_to)
            keep = torch.ones_like(b.mask)
            for a, (x, _) in enumerate(splits):
                keep[a, len(x) // 2:] = 0
            return b._replace(mask=b.mask * keep)

        with _patch(driver, "make_agent_batch", half):
            yield
    elif kind == "altered":
        real = qk.features_from_angles

        def off(spec, angles):
            return real(spec, angles) * 1.001

        with _patch(qk, "features_from_angles", off), \
                _patch(consensus, "features_from_angles", off):
            yield
    else:
        raise ValueError(kind)


@contextlib.contextmanager
def posterior_fault(kind: str):
    import dqgp_tpu_torch.parallel.blocked as blocked

    if kind == "unchanged":
        def still(matvec, b, tol=1e-6, maxiter=256, diag_precond=None):
            return blocked.CGResult(torch.zeros_like(b), 0, 1.0)

        with _patch(blocked, "cg_solve", still):
            yield
    elif kind == "half":
        real = blocked.gp_posterior_large

        def half(spec, F_train, y_train, *args, **kw):
            n = F_train.shape[0] // 2
            return real(spec, F_train[:n], y_train[:n], *args, **kw)

        with _patch(blocked, "gp_posterior_large", half):
            yield
    elif kind == "altered":
        real = blocked.gp_posterior_large

        def off(*args, **kw):
            mean, var, res = real(*args, **kw)
            return mean + 0.01, var, res

        with _patch(blocked, "gp_posterior_large", off):
            yield
    else:
        raise ValueError(kind)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 stored mantissa bits (to nearest, ties
    away), as the tensor cores take their operands."""
    i = x.float().contiguous().view(torch.int32)
    i = (i + 0x1000) & ~0x1FFF
    return i.view(torch.float32)
