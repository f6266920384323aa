"""The port's precision policy.

* Statevectors and Pauli features run in float32 / complex64 (the CUDA
  Pauli-feature kernel is float32-only, like the Pallas kernel it replaces).
* The GP side (Grams handed to solves, NLL, gradients, CV folds, posterior)
  runs in direct float64, which is native on the card — the JAX package's
  ``resolve_dtype_mode("auto")`` picks the same on CPU and GPU. Its "mixed"
  solver and "float32" mode exist for emulated float64 on TPUs and are not
  ported.
* TF32 is off. ``_sqdist`` is a matmul, and Matérn Grams built from nearly
  parallel features go indefinite under reduced-precision products (the
  JAX package pins ``jax_default_matmul_precision="highest"`` for the same
  reason). PyTorch's float32 matmul defaults to full precision, but cuDNN's
  TF32 default is on, so both flags are set explicitly and the Gram path
  asserts them.
"""

from __future__ import annotations

import torch

GP_DTYPE = torch.float64


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
