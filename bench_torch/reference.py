"""The plain reference: the configurations' mathematics in plain PyTorch.

It imports nothing of the program and takes nothing the program made: the
circuit comes from the configuration's own gate list, the data from the
benchmark's generator. It follows the upstream project's definitions
(main.py, agent_riemannian.py, riemannian_optimizer.py of
mpala-lab/distributed-quantum-gaussian-processes):

* a statevector of the encoding circuit on |0...0>, rotation angles
  ``const + pc*theta + (fc + pf*theta) * enc(x)`` (enc: identity or
  arccos of x clipped to [-1, 1]), qubit 0 the least-significant bit;
* projected features <X_q>, <Y_q>, <Z_q> and a Matern(nu = 1.5, length 1)
  outer kernel on them;
* each agent's GP NLL 0.5 logdet C + 0.5 y^T C^-1 y + 0.5 n log 2pi with
  C = K + sigma^2 I, its gradient 0.5 sum((C^-1 - alpha alpha^T) * dK_p)
  with dK_p the h = pi/8 central difference of the Gram, the shifted
  parameters wrapped to [0, pi) in float32;
* the consensus step: z the circular mean of theta + psi/rho (period pi)
  rounded to 4 decimals, theta = wrap(z - (round4(grad) + psi)/(rho + L)),
  psi = psi + rho * wrap(theta - z), both rounded to 4 decimals;
* k-fold CV NLPD with sklearn's shuffled KFold, C = K + (sigma^2 + 1e-6) I;
* condition numbers max|w| / min|w| of each agent's float64 Gram;
* the exact GP posterior from a dense Cholesky.

Precision follows the configuration: float32 circuits and Grams, float64
solves, unless the caller asks for more (``float64`` states for the
condition numbers) or less (the controls).
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch

PERIOD = math.pi
SQRT3 = math.sqrt(3.0)
ROTATIONS = {"rx", "ry", "rz", "crx", "crz"}
ARCCOS = "arccos"


def cdtype(real: torch.dtype) -> torch.dtype:
    return torch.complex128 if real == torch.float64 else torch.complex64


class Circuit:
    """The configuration's gate list (``circuit.gates``: one dict a gate),
    of the kinds the program's eight encoding families build (rx, ry, rz,
    crx, crz, cx, cz, h), so that a configuration of any family is data."""

    def __init__(self, cfg_circuit: dict, device):
        self.n = int(cfg_circuit["qubits"])
        self.gates = list(cfg_circuit["gates"])
        self.device = torch.device(device)
        cols = {k: [float(g.get(k, 0.0)) for g in self.gates]
                for k in ("const", "pc", "fc", "pf")}
        self.coef = {k: torch.tensor(v, dtype=torch.float64, device=self.device)
                     for k, v in cols.items()}
        self.pidx = torch.tensor([max(int(g.get("p", -1)), 0) for g in self.gates],
                                 device=self.device)
        self.has_p = torch.tensor([float(int(g.get("p", -1)) >= 0) for g in self.gates],
                                  dtype=torch.float64, device=self.device)
        self.fidx = torch.tensor([max(int(g.get("f", -1)), 0) for g in self.gates],
                                 device=self.device)
        self.has_f = torch.tensor([float(int(g.get("f", -1)) >= 0) for g in self.gates],
                                  dtype=torch.float64, device=self.device)
        self.arccos = torch.tensor([g.get("enc") == ARCCOS for g in self.gates],
                                   device=self.device)

    def angles(self, X: torch.Tensor, theta: torch.Tensor, real) -> torch.Tensor:
        """(..., N, G) angles of rows X (..., N, D) at theta (..., P)."""
        c = {k: v.to(real) for k, v in self.coef.items()}
        th = torch.cat([theta.to(real), theta.new_zeros(theta.shape[:-1] + (1,)).to(real)], -1)
        tg = (th[..., self.pidx] * self.has_p.to(real))[..., None, :]
        x = X.to(real)[..., self.fidx]
        enc = torch.where(self.arccos, torch.arccos(torch.clamp(x, -1.0, 1.0)), x)
        enc = enc * self.has_f.to(real)
        return c["const"] + c["pc"] * tg + (c["fc"] + c["pf"] * tg) * enc

    def states(self, angles: torch.Tensor) -> torch.Tensor:
        """(B, 2^n) states from (B, G) angles, in the angles' precision."""
        B, n = angles.shape[0], self.n
        psi = torch.zeros((B, 1 << n), dtype=cdtype(angles.dtype), device=angles.device)
        psi[:, 0] = 1
        for gi, g in enumerate(self.gates):
            psi = self._apply(psi, g, angles[:, gi])
        return psi

    def _apply(self, psi, g, a):
        """Gate ``g`` on ``psi`` in place, at per-sample angles ``a``."""
        s0, s1 = halves(psi, self.n, int(g["q"]), int(g.get("c", -1)))
        kind = g["kind"]
        if kind == "cx":
            t = s0.clone()
            s0.copy_(s1)
            s1.copy_(t)
            return psi
        if kind == "cz":
            s1.neg_()
            return psi
        if kind == "h":
            t = s0.clone()
            s0.add_(s1).mul_(1 / math.sqrt(2.0))
            s1.sub_(t).mul_(-1 / math.sqrt(2.0))
            return psi
        if kind not in ROTATIONS:
            raise ValueError(f"gate kind {kind!r}")
        shape = (-1,) + (1,) * (s0.dim() - 1)
        co = torch.cos(a / 2).reshape(shape)
        si = torch.sin(a / 2).reshape(shape)
        zero = torch.zeros_like(co)
        base = kind[-2:]
        if base == "rz":
            s0.mul_(torch.complex(co, -si))
            s1.mul_(torch.complex(co, si))
            return psi
        if base == "rx":
            u00, u01 = torch.complex(co, zero), torch.complex(zero, -si)
            u10, u11 = u01, u00
        else:  # ry
            u00, u01 = torch.complex(co, zero), torch.complex(-si, zero)
            u10, u11 = torch.complex(si, zero), u00
        t = s0.clone()
        s0.mul_(u00).addcmul_(s1, u01)
        s1.mul_(u11).addcmul_(t, u10)
        return psi

    def features(self, X: torch.Tensor, theta: torch.Tensor, real=torch.float32,
                 chunk: int = 1 << 16) -> torch.Tensor:
        """Projected features (..., N, 3n): <X_q>..., <Y_q>..., <Z_q>...,
        in chunks of rows."""
        ang = self.angles(X, theta, real)
        flat = ang.reshape(-1, ang.shape[-1])
        out = [pauli(self.states(flat[s:s + chunk]), self.n)
               for s in range(0, flat.shape[0], chunk)]
        return torch.cat(out).reshape(*ang.shape[:-1], 3 * self.n)


def halves(psi: torch.Tensor, n: int, q: int, c: int = -1):
    """Views of the amplitudes whose qubit q is 0 and 1, where the control
    qubit c (if any) is 1: (B, ...) each."""
    B = psi.shape[0]
    if c < 0:
        v = psi.view(B, 1 << (n - 1 - q), 2, 1 << q)
        return v[:, :, 0], v[:, :, 1]
    hi, lo = max(q, c), min(q, c)
    v = psi.view(B, 1 << (n - 1 - hi), 2, 1 << (hi - 1 - lo), 2, 1 << lo)
    if c > q:
        v = v[:, :, 1]
        return v[:, :, :, 0], v[:, :, :, 1]
    v = v[:, :, :, :, 1]
    return v[:, :, 0], v[:, :, 1]


def pauli(psi: torch.Tensor, n: int) -> torch.Tensor:
    B = psi.shape[0]
    xs, ys, zs = [], [], []
    for q in range(n):
        v = psi.reshape(B, 1 << (n - 1 - q), 2, 1 << q)
        s0, s1 = v[:, :, 0], v[:, :, 1]
        cross = torch.sum(torch.conj(s0) * s1, dim=(1, 2))
        xs.append(2 * cross.real)
        ys.append(2 * cross.imag)
        zs.append(torch.sum(s0.abs() ** 2 - s1.abs() ** 2, dim=(1, 2)))
    return torch.stack(xs + ys + zs, -1)


def matern(FA: torch.Tensor, FB: torch.Tensor) -> torch.Tensor:
    """Matern nu = 1.5, length scale 1, on squared distances from one
    product (leading batch dimensions allowed)."""
    d2 = ((FA * FA).sum(-1)[..., :, None] + (FB * FB).sum(-1)[..., None, :]
          - 2 * FA @ FB.transpose(-1, -2))
    k = SQRT3 * torch.sqrt(torch.clamp(d2, min=0.0) + 1e-30)
    return (1 + k) * torch.exp(-k)


def gram(kernel: dict, FA, FB):
    if kernel["type"] != "projected" or kernel["outer"] != "matern" or kernel["nu"] != 1.5:
        raise ValueError(f"the reference has no kernel {kernel}")
    return matern(FA, FB)


def round4(x: torch.Tensor) -> torch.Tensor:
    return torch.round(x * 1e4) * 1e-4


def wrap(x: torch.Tensor) -> torch.Tensor:
    tiny = torch.finfo(x.dtype).tiny
    x = torch.where(x.abs() < tiny, torch.zeros_like(x), x)
    m = torch.remainder(x, PERIOD)
    return torch.where(m.abs() < tiny, torch.zeros_like(m), m)


def consensus(theta: torch.Tensor, psi: torch.Tensor, rho: float) -> torch.Tensor:
    ph = 2 * math.pi * (theta + psi / rho) / PERIOD
    z = torch.atan2(torch.sin(ph).sum(0), torch.cos(ph).sum(0)) * PERIOD / (2 * math.pi)
    return round4(torch.remainder(z, PERIOD))


def signed_arc(x, y):
    return torch.remainder(y - x + PERIOD / 2, PERIOD) - PERIOD / 2


class Agents:
    """The agents' shards padded to the largest, with masks."""

    def __init__(self, splits, device):
        n_max = max(len(x) for x, _ in splits)
        A, d = len(splits), splits[0][0].shape[1]
        X = np.zeros((A, n_max, d))
        Y = np.zeros((A, n_max))
        m = np.zeros((A, n_max))
        for a, (xa, ya) in enumerate(splits):
            X[a, :len(xa)], Y[a, :len(xa)], m[a, :len(xa)] = xa, ya, 1
        self.raw = [np.asarray(x, np.float64) for x, _ in splits]
        self.X = torch.as_tensor(X, dtype=torch.float32, device=device)
        self.Y = torch.as_tensor(Y, dtype=torch.float64, device=device)
        self.m = torch.as_tensor(m, dtype=torch.float64, device=device)


def _padded_C(K: torch.Tensor, m: torch.Tensor, noise2: float) -> torch.Tensor:
    m2 = m[..., :, None] * m[..., None, :]
    return K * m2 + torch.diag_embed(1 - m) + noise2 * torch.diag_embed(m)


def agent_nll(circ: Circuit, kernel: dict, ag: Agents, z: torch.Tensor, noise: float,
              gp=torch.float64, with_grad: bool = False, h: float = math.pi / 8):
    """Every agent's NLL at wrap(z) (A,), and with ``with_grad`` its
    central-difference gradient (A, P)."""
    z32 = wrap(z.to(torch.float64)).to(torch.float32)
    F = circ.features(ag.X, z32)
    K = gram(kernel, F, F).to(gp)
    m = ag.m.to(gp)
    y = ag.Y.to(gp) * m
    C = _padded_C(K, m, noise**2)
    L = torch.linalg.cholesky(C)
    alpha = torch.cholesky_solve(y[..., None], L)[..., 0]
    nll = (torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1)
           + 0.5 * (y * alpha).sum(-1) + 0.5 * m.sum(-1) * math.log(2 * math.pi))
    if not with_grad:
        return nll, None
    eye = torch.eye(C.shape[-1], dtype=gp, device=C.device).expand_as(C)
    bracket = torch.cholesky_solve(eye, L) - alpha[..., :, None] * alpha[..., None, :]
    bracket = bracket * (m[..., :, None] * m[..., None, :])
    P = z32.shape[0]
    grads = []
    for p in range(P):
        e = torch.zeros_like(z32)
        e[p] = h
        Fp = circ.features(ag.X, torch.remainder(z32 + e, PERIOD))
        Fm = circ.features(ag.X, torch.remainder(z32 - e, PERIOD))
        dK = ((gram(kernel, Fp, Fp) - gram(kernel, Fm, Fm)) / (2 * h)).to(gp)
        grads.append(0.5 * (bracket * dK.transpose(-1, -2)).sum((-2, -1)))
    return nll, torch.stack(grads, -1)


def admm_update(z, grad, psi, rho: float, L: float):
    zm = wrap(z)
    theta = wrap(zm - (round4(grad) + psi) / (rho + L))
    psi = psi + rho * wrap(theta - zm)
    return round4(theta), round4(psi)


def init_state(n_agents: int, P: int, seed: int):
    """theta, psi ~ U(0, 1) rounded to 4 decimals after np.random.seed
    (main.py:2403-2461)."""
    np.random.seed(seed)
    theta = np.round(np.random.rand(n_agents, P), 4)
    psi = np.round(np.random.rand(n_agents, P), 4)
    return theta, psi


def kfold(n: int, k: int, seed: int):
    """sklearn's KFold(shuffle=True, random_state=seed): (train, val) index
    arrays, each ascending."""
    idx = np.arange(n)
    np.random.RandomState(seed).shuffle(idx)
    sizes = np.full(k, n // k)
    sizes[: n % k] += 1
    out, at = [], 0
    for s in sizes:
        val = np.sort(idx[at:at + s])
        out.append((np.setdiff1d(np.arange(n), val), val))
        at += s
    return out


def posterior(K_tt, K_st, k_ss, y, noise2: float):
    """Exact posterior mean and variance (clamped at 1e-10) from a dense
    Cholesky of K_tt + noise2 I."""
    C = K_tt + noise2 * torch.eye(K_tt.shape[-1], dtype=K_tt.dtype, device=K_tt.device)
    L = torch.linalg.cholesky(C)
    alpha = torch.cholesky_solve(y[:, None], L)[:, 0]
    v = torch.linalg.solve_triangular(L, K_st.transpose(0, 1), upper=False)
    return K_st @ alpha, torch.clamp(k_ss - (v * v).sum(0), min=1e-10)


def cv_score(circ: Circuit, kernel: dict, X: np.ndarray, Y: np.ndarray, z, noise: float,
             folds: int, seed: int, gp=torch.float64, device="cpu") -> float:
    """Mean k-fold NLPD at z (the mean of the finite folds, if at least
    k // 2 are)."""
    Xt = torch.as_tensor(X, dtype=torch.float32, device=device)
    F = circ.features(Xt, torch.as_tensor(z, device=device).to(torch.float32)).to(gp)
    Yt = torch.as_tensor(Y, dtype=gp, device=device)
    scores = []
    for tr, va in kfold(len(X), folds, seed):
        tr_i = torch.as_tensor(tr, device=device)
        va_i = torch.as_tensor(va, device=device)
        Ftr, Fva = F[tr_i], F[va_i]
        mean, var = posterior(gram(kernel, Ftr, Ftr).to(gp), gram(kernel, Fva, Ftr).to(gp),
                              torch.ones(len(va), dtype=gp, device=device), Yt[tr_i],
                              noise**2 + 1e-6)
        r = Yt[va_i] - mean
        scores.append(float(torch.mean(0.5 * math.log(2 * math.pi) + 0.5 * torch.log(var)
                                       + 0.5 * r * r / var)))
    finite = [s for s in scores if np.isfinite(s)]
    return float(np.mean(finite)) if len(finite) >= folds // 2 else float("inf")


def condition_numbers(circ: Circuit, kernel: dict, ag: Agents, z_rows: np.ndarray,
                      device) -> np.ndarray:
    """(T, A) condition numbers of each agent's float64 Gram (complex128
    states) at wrap(z) of each row."""
    out = np.empty((len(z_rows), len(ag.raw)))
    for t, z in enumerate(z_rows):
        zw = wrap(torch.as_tensor(z, dtype=torch.float64, device=device))
        for a, Xa in enumerate(ag.raw):
            F = circ.features(torch.as_tensor(Xa, device=device), zw, torch.float64)
            w = torch.linalg.eigvalsh(gram(kernel, F, F)).abs()
            out[t, a] = float(w.max() / torch.clamp(w.min(), min=torch.finfo(w.dtype).tiny))
    return out


def follow(circ: Circuit, kernel: dict, ag: Agents, admm: dict, seed: int, steps: int,
           gp=torch.float64) -> Dict[str, List]:
    """The consensus chain from the seeded start: z_1 .. z_{steps+1}, and
    each step's agent NLLs at its own z."""
    theta0, psi0 = init_state(len(ag.raw), circ_params(circ), seed)
    dev = ag.X.device
    theta = torch.as_tensor(theta0, dtype=torch.float64, device=dev)
    psi = torch.as_tensor(psi0, dtype=torch.float64, device=dev)
    zs, nlls = [], []
    for _ in range(steps):
        z = consensus(theta, psi, admm["rho"])
        nll, grad = agent_nll(circ, kernel, ag, z, admm["noise_std"], gp, with_grad=True)
        theta, psi = admm_update(z, grad, psi, admm["rho"], admm["L"])
        zs.append(z.cpu().numpy())
        nlls.append(nll.cpu().numpy())
    zs.append(consensus(theta, psi, admm["rho"]).cpu().numpy())
    return {"z": zs, "nll": nlls}


def circ_params(circ: Circuit) -> int:
    return int(max(int(g.get("p", -1)) for g in circ.gates)) + 1


def change_norms(zs: Sequence[np.ndarray]) -> List[float]:
    """||arc(z_1 -> z_{k+1})|| for k = 1, 2, ...: the consensus' change
    after each step."""
    z1 = torch.as_tensor(np.asarray(zs[0], np.float64))
    return [float(torch.linalg.norm(signed_arc(z1, torch.as_tensor(np.asarray(z, np.float64)))))
            for z in zs[1:]]
