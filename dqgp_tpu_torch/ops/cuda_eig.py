"""Wrapper of the hand-written batched eigenvalue kernel (``csrc/gram_extremes.cu``).

``gram_extremes(grams)`` returns, for every symmetric float64 Gram of a list
of (T, n, n) batches, max|w| and min|w| over its eigenvalues w: the two numbers
the condition-number backfill (``driver.host_condition_numbers``) reads. It
replaces no TPU kernel: the JAX package computes them on the host's LAPACK.

On the card, every batch whose n the kernel takes (``takes_kernel``: 1 to
``MAX_N``) goes through ONE launch, one thread-block cluster a Gram, the
cluster's size set by the launch's largest n (``cluster_size``): its Gram's
lower triangle has to fit the cluster's shared memory (``smem_bytes``, the
kernel's ``layout``). A batch above ``MAX_N`` goes through
``torch.linalg.eigvalsh`` (``gram_extremes_reference``), as does every batch
on the CPU. The kernel reads NaN for both numbers of a Gram with a
non-finite entry, on which eigvalsh raises ``torch.linalg.LinAlgError`` or
reads NaN; the backfill raises. The counts (``launches``; ``grams`` the
Grams the kernel took, ``eigvalsh_grams`` those the card sent to eigvalsh)
are read and reset through ``cuda_circuit.launch_counts`` with the circuit
kernels' counts; the CPU counts nothing.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Iterable, Optional, Sequence

import torch

from .. import tracing
from . import _build

SOURCE = "gram_extremes.cu"
THREADS = 512                  # the kernel's kThreads
TARGETS = 4                    # its kTargets
CLUSTER_SIZES = (1, 2, 4, 8)   # blocks a cluster (8: the portable most)
SMEM_BUDGET = 232_448          # bytes of shared memory a block may take on an H100

_vp, _i32, _i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _own_rows(n: int, r: int, C: int) -> int:
    return (n - r + C - 1) // C if r < n else 0


def _row_offset(l: int, r: int, C: int) -> int:
    return l * (r + 1) + C * l * (l - 1) // 2


def smem_words(nmax: int, C: int) -> int:
    """Doubles of shared memory a block takes for a launch whose largest Gram
    has ``nmax`` rows, in clusters of ``C`` blocks: the kernel's ``layout``
    (the own rows packed, column k twice, the ranks' partial p, p, the column
    and row parts, d, e, the flags and the wanted eigenvalues)."""
    rows = max(_row_offset(_own_rows(nmax, r, C), r, C) for r in range(C))
    pad = (nmax + 31) // 32 * 32
    return (rows + 2 * nmax + C * nmax + nmax + max(pad, THREADS) + -(-nmax // C)
            + 2 * nmax + 8 + TARGETS)


def smem_bytes(nmax: int, C: int) -> int:
    return 8 * smem_words(nmax, C)


@functools.lru_cache(maxsize=None)
def cluster_limit(C: int) -> int:
    """The most rows a Gram may have for clusters of ``C`` blocks."""
    n = 1
    while smem_bytes(n + 1, C) <= SMEM_BUDGET:
        n += 1
    return n


def cluster_size(n: int) -> Optional[int]:
    """The smallest cluster that holds a Gram of ``n`` rows; None above ``MAX_N``."""
    return next((C for C in CLUSTER_SIZES if n <= cluster_limit(C)), None)


MAX_N = cluster_limit(CLUSTER_SIZES[-1])


def _on_card(device) -> bool:
    return torch.device(device).type == "cuda"


def takes_kernel(n: int, device) -> bool:
    """Whether Grams of ``n`` rows on ``device`` go through the kernel."""
    return _on_card(device) and 1 <= n <= MAX_N


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    with tracing.span(f"cuda_circuit.load:{SOURCE}"):
        lib = _build.load(SOURCE)
    lib.dqgp_gram_extremes.argtypes = [_vp, _vp, _i32, _i32, _i32, _i64, _vp]
    lib.dqgp_gram_extremes.restype = _i32
    lib.dqgp_gram_extremes_smem_bytes.argtypes = [_i32, _i32]
    lib.dqgp_gram_extremes_smem_bytes.restype = _i64
    lib.dqgp_gram_extremes_max_clusters.argtypes = [_i32, _i64]
    lib.dqgp_gram_extremes_max_clusters.restype = _i32
    lib.dqgp_cuda_error_string.argtypes = [_i32]
    lib.dqgp_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _launch(table: torch.Tensor, out: torch.Tensor, nmax: int, C: int, device) -> None:
    """One launch on the current stream of ``device``: Gram g of ``table``
    (G, 2) [address, n] into row g of ``out`` (G, 2); raise if refused."""
    lib = _library()
    with torch.cuda.device(device):
        err = lib.dqgp_gram_extremes(table.data_ptr(), out.data_ptr(), table.shape[0], nmax, C,
                                     smem_bytes(nmax, C),
                                     torch._C._cuda_getCurrentRawStream(device.index))
    if err != 0:
        raise RuntimeError("dqgp_gram_extremes kernel launch failed: "
                           + lib.dqgp_cuda_error_string(err).decode())


def gram_extremes_reference(grams: torch.Tensor) -> torch.Tensor:
    """(T, n, n) -> (T, 2): max|w| and min|w| of each Gram by eigvalsh."""
    w = torch.abs(torch.linalg.eigvalsh(grams))
    return torch.stack([torch.amax(w, dim=-1), torch.amin(w, dim=-1)], dim=-1)


def _check(g: torch.Tensor, device: torch.device) -> None:
    if g.device != device:
        raise ValueError(f"gram_extremes: Grams on {g.device} and {device}")
    if g.dtype != torch.float64:
        raise TypeError(f"gram_extremes takes float64 Grams, got {g.dtype}")
    if g.dim() != 3 or g.shape[1] != g.shape[2] or g.shape[1] < 1:
        raise ValueError(f"gram_extremes takes (T, n, n) batches with n >= 1, "
                         f"got {tuple(g.shape)}")
    if not g.is_contiguous():
        raise ValueError("gram_extremes takes contiguous batches")


def _kernel_extremes(grams: Sequence[torch.Tensor], device) -> torch.Tensor:
    """Every Gram of ``grams`` (batches the kernel takes) in one launch."""
    table = [(g.data_ptr() + t * g.shape[1] ** 2 * 8, g.shape[1])
             for g in grams for t in range(g.shape[0])]
    out = torch.empty((len(table), 2), dtype=torch.float64, device=device)
    if table:
        nmax = max(n for _, n in table)
        # from pageable memory without a wait: the runtime stages the copy at once
        _launch(torch.tensor(table).to(device, non_blocking=True), out, nmax,
                cluster_size(nmax), device)
        gram_extremes.launches += 1
        gram_extremes.grams += len(table)
    return out


def gram_extremes(grams: Iterable[torch.Tensor]) -> torch.Tensor:
    """Batches (T_a, n_a, n_a) float64 of symmetric Grams, each read by its
    lower triangle -> (sum T_a, 2) float64: max|w| and min|w| of each Gram,
    batch 0's first. On the card one launch takes every batch whose n the
    kernel takes (it reads NaN for a Gram with a non-finite entry), and the
    call does not wait for it. The batches are read one at a time: a batch
    that goes to eigvalsh is reduced before the next is drawn, so an
    iterator that builds them holds no more than one such batch at once."""
    parts, batched, device = [], [], None
    for g in grams:
        device = g.device if device is None else device
        _check(g, device)
        if takes_kernel(g.shape[1], device):
            batched.append(g)
            parts.append(g.shape[0])
        else:
            parts.append(gram_extremes_reference(g))
            if _on_card(device):
                gram_extremes.eigvalsh_grams += g.shape[0]
    got = _kernel_extremes(batched, device)
    if len(batched) == len(parts):
        return got
    at = 0
    for i, p in enumerate(parts):
        if isinstance(p, int):
            parts[i], at = got[at:at + p], at + p
    return torch.cat(parts)


gram_extremes.launches = 0
gram_extremes.grams = 0
gram_extremes.eigvalsh_grams = 0
