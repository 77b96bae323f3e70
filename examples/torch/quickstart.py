"""Quickstart: exact analytical cross-validation in five lines.

Run:  PYTHONPATH=src python examples/torch/quickstart.py [--device cpu]

On the card by default (the hand-written CUDA kernels); ``--device cpu``
runs the plain PyTorch versions.
"""

import argparse

import numpy as np
import torch

from repro_torch.core import fastcv, folds, lda, metrics
from repro_torch.data import synthetic

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
dev = ap.parse_args().device

# a P >> N problem — the paper's home turf
x, yc = synthetic.make_classification(0, n=100, p=2000, class_sep=2.5, device=dev)
y = torch.where(yc == 0, -1.0, 1.0).to(x.dtype)
f = folds.kfold(100, k=10, seed=0, device=dev)

# analytical approach: ONE fit, exact CV decision values for every fold
dvals, y_te = fastcv.binary_cv(x, y, f, lam=1.0, adjust_bias=False)
print(f"analytical  acc={float(metrics.binary_accuracy(dvals, y_te)):.3f} "
      f"auc={float(metrics.auc(dvals.ravel(), y_te.ravel())):.3f}")

# standard approach (retrain 10x) — identical predictions, far more work
dv_std, _ = lda.standard_cv_binary(x, y, f, lam=1.0, form="regression")
np.testing.assert_allclose(dvals.cpu().numpy(), dv_std.cpu().numpy(), rtol=1e-7, atol=1e-8)
print("standard (retrained) decision values match to machine precision ✓")
