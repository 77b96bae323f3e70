"""EEG/MEG-style permutation testing (paper §2.13 / Fig. 4 workflow).

Simulates a multi-subject 380-channel dataset, then runs per-subject
permutation tests with 10-fold CV — binary (faces vs scrambled) on
windowed features (P = 3800) and 3-class LDA (P = 1900) — using the
analytical engine (Algorithm 1 & 2).

Run:  PYTHONPATH=src python examples/torch/eeg_permutation.py [--device cpu]
"""

import argparse
import time

import torch

from repro_torch.core import folds, permutation
from repro_torch.data import eeg

N_SUBJECTS = 3
N_TRIALS = 192
N_PERM = 100

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
dev = ap.parse_args().device


def sync():
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


for subj in range(N_SUBJECTS):
    f = folds.kfold(N_TRIALS, 10, seed=subj, device=dev)

    ds2 = eeg.simulate_subject(2 * subj, n_trials=N_TRIALS, num_classes=2, device=dev)
    x2 = eeg.windowed_features(ds2, 100.0).double()               # P = 3800
    y2 = torch.where(ds2.y == 0, -1.0, 1.0).double()
    t0 = time.perf_counter()
    res2 = permutation.analytical_permutation_binary(
        x2, y2, f, lam=1.0, n_perm=N_PERM, seed=subj, chunk=50)
    sync()
    t2 = time.perf_counter() - t0

    ds3 = eeg.simulate_subject(2 * subj + 1, n_trials=N_TRIALS, num_classes=3, device=dev)
    x3 = eeg.windowed_features(ds3, 200.0).double()               # P = 1900
    t0 = time.perf_counter()
    res3 = permutation.analytical_permutation_multiclass(
        x3, ds3.y, f, num_classes=3, lam=1.0, n_perm=N_PERM, seed=subj, chunk=10)
    sync()
    t3 = time.perf_counter() - t0

    print(f"subject {subj}:")
    print(f"  binary  P=3800: acc={float(res2.observed):.3f} "
          f"p={float(res2.p):.3f}  ({N_PERM} perms in {t2:.1f}s)")
    print(f"  3-class P=1900: acc={float(res3.observed):.3f} "
          f"p={float(res3.p):.3f}  ({N_PERM} perms in {t3:.1f}s)")
