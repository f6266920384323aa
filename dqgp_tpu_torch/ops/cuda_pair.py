"""Wrapper of the streamed gradient's contraction kernel (``csrc/shift_pair_contract.cu``).

``shift_pair_contract(F, bracket, mask, h, length_scale, nu, out)`` gives,
for one parameter p, every agent's

    g_p = 1/2 sum_ij bracket[j, i] * m_i m_j * f64((K+[i, j] - K-[i, j]) / 2h)

from the features at the +h and -h shifts, F (A, 2, N, D) float32, where
K+- is the projected kernel's Matern Gram of F[:, 0] and F[:, 1]: the body
of ``parallel.consensus.streamed_nll_and_grad``'s loop. It replaces no TPU
kernel: the JAX package forms the Gram pair and contracts it in XLA.

On the card one call is two launches (the tiles, then each agent's fixed-
order sum) inside the span ``cuda_circuit.launch:pair_contract``, counted
once, as a call, under ``pair_contract`` in ``cuda_circuit.launch_counts()``;
the library loads on first use inside
``cuda_circuit.load:shift_pair_contract.cu``, so a run that never takes the
path never loads it. It writes into ``out``, a (A,) float64 view on the
card (a column of the gradient), and reads nothing back. On the CPU it runs
``shift_pair_contract_reference``, the loop's PyTorch arithmetic for one
parameter (``contract_pair`` on the Matern pair), and counts nothing.

The streamed gradient takes the kernel where ``takes_kernel`` holds: float32
features on the card, a float64 GP side, the projected kernel with no
regularization (the loop regularizes each shifted Gram otherwise) and the
Matern outer kernel at one of its closed-form nu, and D <= ``max_d()``,
the kernel's own limit (the width is asked last, so only a run that would
otherwise take the kernel loads the library to read it).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import tracing
from . import _build

SOURCE = "shift_pair_contract.cu"
NU_CODES = {0.5: 0, 1.5: 1, 2.5: 2, float("inf"): 3}   # the kernel's closed forms

_vp, _i32, _i64, _f64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_double


def matern_params(spec) -> tuple:
    """(length_scale, nu) of ``spec``'s Matern, with ``outer_gram``'s defaults."""
    p = spec.outer_params
    return float(p.get("length_scale", 1.0)), float(p.get("nu", 1.5))


def takes_kernel(spec, device, feature_dtype: torch.dtype, width: int,
                 gp_dtype: torch.dtype) -> bool:
    """Whether the streamed gradient of ``spec`` takes the kernel, for
    features of ``width`` columns and ``feature_dtype`` on ``device`` and a
    GP side in ``gp_dtype``."""
    return (torch.device(device).type == "cuda" and feature_dtype == torch.float32
            and gp_dtype == torch.float64 and spec.kernel_type == "projected"
            and spec.outer_kernel == "matern" and spec.regularization is None
            and matern_params(spec)[1] in NU_CODES and 1 <= width <= max_d())


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    with tracing.span(f"cuda_circuit.load:{SOURCE}"):
        lib = _build.load(SOURCE)
    lib.dqgp_shift_pair_contract.argtypes = [_vp] * 5 + [_i32] * 3 + [_i64, _f64, _f64, _i32,
                                                                      _vp]
    lib.dqgp_shift_pair_contract.restype = _i32
    lib.dqgp_shift_pair_contract_smem_bytes.argtypes = [_i32]
    lib.dqgp_shift_pair_contract_smem_bytes.restype = _i64
    lib.dqgp_shift_pair_contract_blocks_per_sm.argtypes = [_i32, _i32]
    lib.dqgp_shift_pair_contract_blocks_per_sm.restype = _i32
    lib.dqgp_shift_pair_contract_max_d.argtypes = []
    lib.dqgp_shift_pair_contract_max_d.restype = _i32
    lib.dqgp_shift_pair_contract_slots.argtypes = [_i32]
    lib.dqgp_shift_pair_contract_slots.restype = _i32
    lib.dqgp_cuda_error_string.argtypes = [_i32]
    lib.dqgp_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def max_d() -> int:
    """The widest feature row the kernel takes (its ``kMaxD``)."""
    return _library().dqgp_shift_pair_contract_max_d()


def contract_pair(Kpm: torch.Tensor, bracket_t: torch.Tensor, m2: torch.Tensor,
                  h: float) -> torch.Tensor:
    """g_p of every agent from its Gram pair Kpm (A, 2, N, N) at +h and -h,
    the transposed bracket and the mask product (A, N, N): dK_p differenced
    in the pair's float32, upcast, masked and contracted."""
    dk = ((Kpm[:, 0] - Kpm[:, 1]) / (2.0 * h)).to(bracket_t.dtype) * m2
    return 0.5 * torch.sum(bracket_t * dk, dim=(-2, -1))


def shift_pair_contract_reference(F: torch.Tensor, bracket: torch.Tensor, mask: torch.Tensor,
                                  h: float, length_scale: float = 1.0,
                                  nu: float = 1.5) -> torch.Tensor:
    """The kernel's plain version: the Matern Gram pair of F (A, 2, N, D)
    as ``gram_from_features`` forms it, then ``contract_pair``. -> (A,)."""
    # imported here: models.kernels imports ops.cuda_circuit, which imports this module
    from ..models.kernels.outer import outer_gram

    Kpm = outer_gram("matern", F, F, {"length_scale": length_scale, "nu": nu})
    m2 = mask[:, :, None] * mask[:, None, :]
    return contract_pair(Kpm, bracket.transpose(-1, -2), m2, h)


def _check(F, bracket, mask, out, nu) -> None:
    dev = F.device
    if F.dim() != 4 or F.shape[1] != 2 or F.dtype != torch.float32:
        raise ValueError(f"shift_pair_contract takes (A, 2, N, D) float32 features, got "
                         f"{tuple(F.shape)} {F.dtype}")
    A, _, N, D = F.shape
    if not 1 <= D <= max_d():
        raise ValueError(f"shift_pair_contract takes D in 1..{max_d()}, got {D}")
    if float(nu) not in NU_CODES:
        raise ValueError(f"shift_pair_contract takes nu in {sorted(NU_CODES)}, got {nu}")
    for name, t, shape in (("bracket", bracket, (A, N, N)), ("mask", mask, (A, N)),
                           ("out", out, (A,))):
        if t.device != dev or t.dtype != torch.float64 or tuple(t.shape) != shape:
            raise ValueError(f"shift_pair_contract: {name} must be {shape} float64 on {dev}, "
                             f"got {tuple(t.shape)} {t.dtype} on {t.device}")
    for name, t in (("features", F), ("bracket", bracket), ("mask", mask)):
        if not t.is_contiguous():
            raise ValueError(f"shift_pair_contract takes contiguous {name}")


def shift_pair_contract(F: torch.Tensor, bracket: torch.Tensor, mask: torch.Tensor, h: float,
                        length_scale: float = 1.0, nu: float = 1.5,
                        out: torch.Tensor = None) -> torch.Tensor:
    """g_p (A,) float64 of every agent (see the module docstring), written
    into ``out`` where given. On the card two launches that the call does
    not wait for, counted as one call; on the CPU the plain version."""
    A = F.shape[0]
    if out is None:
        out = torch.empty(A, dtype=torch.float64, device=F.device)
    if F.device.type != "cuda":
        return out.copy_(shift_pair_contract_reference(F, bracket, mask, h, length_scale, nu))
    _check(F, bracket, mask, out, nu)
    N, D = F.shape[2], F.shape[3]
    lib = _library()
    slots = torch.empty(A * lib.dqgp_shift_pair_contract_slots(N), dtype=torch.float64,
                        device=F.device)
    with tracing.span("cuda_circuit.launch:pair_contract"):
        with torch.cuda.device(F.device):
            err = lib.dqgp_shift_pair_contract(
                F.data_ptr(), bracket.data_ptr(), mask.data_ptr(), slots.data_ptr(),
                out.data_ptr(), A, N, D, out.stride(0), 2.0 * h, length_scale,
                NU_CODES[float(nu)], torch._C._cuda_getCurrentRawStream(F.device.index))
    if err != 0:
        raise RuntimeError("dqgp_shift_pair_contract kernel launch failed: "
                           + lib.dqgp_cuda_error_string(err).decode())
    shift_pair_contract.launches += 1
    return out


shift_pair_contract.launches = 0
