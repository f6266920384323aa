from .posterior import gp_posterior_from_grams, masked_nll_and_grad, predict_quantum_gp  # noqa: F401
from .cv import (  # noqa: F401
    FoldIndexBuffers,
    k_fold_cross_validation_consensus,
    kfold_pad_indices,
)
from .metrics import evaluate_predictions, nlpd  # noqa: F401
from .noise import NoiseFitResult, fit_noise_std  # noqa: F401
