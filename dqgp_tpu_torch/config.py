"""The port's precision and fusion policies.

* Statevectors and Pauli features run in float32 / complex64 on the
  production path, like the Pallas kernels they replace. float64 angles run
  the reference-grade complex128 path (the float64 instantiations of the
  Pauli-feature and states kernels on the card), as the JAX package's XLA
  engine does on CPU and GPU.
* The GP side (Grams handed to solves, NLL, gradients, CV folds, posterior)
  runs in direct float64 by default, which is native on the card — the JAX
  package's ``resolve_dtype_mode("auto")`` picks the same on CPU and GPU.
  The driver's ``gp_dtype`` / ``cv_dtype`` may ask for "float32"; the
  "mixed" solver exists for emulated float64 on TPUs and is not ported.
* TF32 is off. ``_sqdist`` is a matmul, and Matérn Grams built from nearly
  parallel features go indefinite under reduced-precision products (the
  JAX package pins ``jax_default_matmul_precision="highest"`` for the same
  reason). PyTorch's float32 matmul defaults to full precision, but cuDNN's
  TF32 default is on, so both flags are set explicitly and the Gram path
  asserts them.
"""

from __future__ import annotations

import os

import torch

GP_DTYPE = torch.float64

_GP_DTYPES = {"float64": torch.float64, "float32": torch.float32}


def resolve_dtype_mode(mode: str) -> str:
    """Resolve a GP/CV linalg dtype mode ("auto" | "float64" | "float32")
    as ``dqgp_tpu/config.py::resolve_dtype_mode`` does off a TPU: "auto" is
    "float64" on the CPU and on CUDA. "mixed" (float32 factorization +
    float64 refinement) answers emulated float64 and is on ROADMAP's "not
    ported on purpose" list (``solve_psd_mixed``)."""
    if mode == "auto":
        return "float64"
    if mode == "mixed":
        raise ValueError(
            "dtype mode 'mixed' is not ported: solve_psd_mixed answers emulated "
            "float64 on TPUs (ROADMAP, 'Not ported on purpose'); float64 is native "
            "on the CPU and the card")
    if mode not in _GP_DTYPES:
        raise ValueError(f"dtype mode must be 'auto', 'float64' or 'float32', got {mode!r}")
    return mode


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device where there is none
    raises rather than leaving the work to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on the card unless asked "
                           "otherwise; pass device='cpu' (the CLI's --device cpu) to "
                           "run on the CPU")
    return dev


def torch_dtype(mode: str) -> torch.dtype:
    """The torch dtype of a GP/CV dtype mode ("auto" resolves first)."""
    return _GP_DTYPES[resolve_dtype_mode(mode)]

# The gate-fusion switch, verbatim from dqgp_tpu/config.py:34-50 (the
# thresholds were measured on a TPU v5e and stay until the card's own K2 vs
# K4 times say otherwise). "auto" fuses only the Pauli-feature path at >= 10
# qubits; "on" fuses everywhere, "off" nowhere. Env: DQGP_FUSION. Read at
# call time, so ``config.use_fusion = "on"`` takes effect at once.
use_fusion: str = os.environ.get("DQGP_FUSION", "auto")

FUSION_MIN_QUBITS_FEATURES: int = int(
    os.environ.get("DQGP_FUSION_MIN_QUBITS", "10"))


def fusion_enabled(num_qubits: int | None = None,
                   path: str = "features") -> bool:
    """Fusion policy. ``path`` is "features" (Pauli features, the
    projected-kernel hot path) or "states" (raw statevectors / fidelity)."""
    if use_fusion == "off":
        return False
    if use_fusion == "on":
        return True
    if num_qubits is None:  # auto with no size context: be conservative
        return False
    return path == "features" and num_qubits >= FUSION_MIN_QUBITS_FEATURES


def set_precision_policy() -> None:
    """Turn TF32 off for matmuls and cuDNN (idempotent)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def check_full_precision_matmul() -> None:
    """Raise if a float32 product on the card could run in TF32."""
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.backends.cudnn.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError(
            "TF32 is enabled: Gram matmuls would lose float32 precision and "
            "Matérn Grams can go indefinite; call "
            "dqgp_tpu_torch.config.set_precision_policy()")


set_precision_policy()
