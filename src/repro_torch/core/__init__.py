# The paper's primary contribution: analytical cross-validation and
# permutation testing for least-squares models (PyTorch port).
from repro_torch.core import (  # noqa: F401
    fastcv,
    folds,
    lda,
    metrics,
    multiclass,
    multidim,
    permutation,
    regression,
    shrinkage,
    tuning,
)
