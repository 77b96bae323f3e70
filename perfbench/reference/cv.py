"""Plain reference for the benchmark's comparisons: cross-validation by
retraining, fold by fold.

The paper's claim (Treder 2018, Eq. 14/15) is that its analytical CV
equals retraining the model on each fold's training rows. This module
retrains: a ridge fit with an unpenalised intercept on each fold's
training rows (centering at the fold's own training mean), evaluated on
its test rows, in the dual form when P >= N_train and the primal form
otherwise. On top of the fold fits:

* binary LDA in regression form with the LDA bias (§2.5): a decision value
  is the test prediction minus the mean of the fold model's training fits
  over each class, averaged over the two classes;
* multi-class LDA by optimal scoring (§2.9-2.10, Algorithm 2): the C×C
  problem M θ = α² D_π θ with M = Ẏ_Trᵀ Y_Tr / N_Tr, the trivial pair
  dropped, W scaled by N^{-1/2} diag(α²(1 − α²))^{-1/2}, nearest centroid
  of the training scores.

Plain PyTorch only, in float64; ``precision="tf32"`` computes the same in
float32 with every product's operands rounded to TF32 (10 mantissa bits),
as the tensor cores' TF32 mode rounds them: the step below the float32
the configurations state, which the benchmark's control takes. TF32 mode
of the libraries themselves stays off, so the rounding is the same on
every device. Nothing here imports the program under test.
"""

from __future__ import annotations

import torch

_EPS = 1e-10


def to_tf32(a: torch.Tensor) -> torch.Tensor:
    """Float32 values rounded to the nearest TF32 value (13 low mantissa
    bits cleared, ties away from zero)."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class FoldRidge:
    """Ridge fits of every fold of one feature matrix, reusable for any
    number of label columns.

    x: (N, P); te: (K, m); tr: (K, N - m) index tensors; lam: the penalty.
    precision: "f64" (the reference) or "tf32" (the control).
    """

    def __init__(self, x: torch.Tensor, te: torch.Tensor, tr: torch.Tensor, lam: float,
                 precision: str = "f64"):
        if precision not in ("f64", "tf32"):
            raise ValueError(f"unknown precision {precision!r}")
        dtype = torch.float64 if precision == "f64" else torch.float32
        self.mm = torch.matmul if precision == "f64" else (
            lambda a, b: torch.matmul(to_tf32(a), to_tf32(b)))
        self.te, self.tr = te.long(), tr.long()
        self.dual = x.shape[1] >= tr.shape[1]
        self.folds = []
        for k in range(te.shape[0]):
            x_tr = x[self.tr[k]].to(dtype)
            mu = x_tr.mean(dim=0, keepdim=True)
            xc = x_tr - mu
            x_te = x[self.te[k]].to(dtype) - mu
            if self.dual:
                a = self.mm(xc, xc.T)
                fit_map, test_map = a, self.mm(x_te, xc.T)  # fits = A α, tests = B α
                xc = None
            else:
                a = self.mm(xc.T, xc)
                fit_map, test_map = xc, x_te                # fits = X_c w, tests = X_te w
            a = a + lam * torch.eye(a.shape[0], dtype=dtype, device=a.device)
            self.folds.append((torch.linalg.cholesky(a), xc, fit_map, test_map))

    def fit(self, y: torch.Tensor):
        """(training fits (K, N - m, B), test predictions (K, m, B)) of the
        fold models for labels / responses y (N, B)."""
        fits, tests = [], []
        for k, (chol, xc, fit_map, test_map) in enumerate(self.folds):
            y_tr = y[self.tr[k]].to(chol.dtype)
            mean = y_tr.mean(dim=0, keepdim=True)
            rhs = y_tr - mean if self.dual else self.mm(xc.T, y_tr - mean)
            coef = torch.cholesky_solve(rhs, chol)
            fits.append(self.mm(fit_map, coef) + mean)
            tests.append(self.mm(test_map, coef) + mean)
        return torch.stack(fits), torch.stack(tests)

    def binary_dvals(self, y: torch.Tensor) -> torch.Tensor:
        """LDA decision values (K, m, B) for ±1 labels y (N, B)."""
        fits, tests = self.fit(y)
        pos = (y[self.tr] > 0).to(fits.dtype)
        neg = 1.0 - pos
        mu1 = (fits * pos).sum(dim=1) / pos.sum(dim=1).clamp(min=1.0)
        mu2 = (fits * neg).sum(dim=1) / neg.sum(dim=1).clamp(min=1.0)
        return tests - 0.5 * (mu1 + mu2)[:, None, :]

    def multiclass_distances(self, classes: torch.Tensor, num_classes: int) -> torch.Tensor:
        """Squared distances (K, m, C) of each test trial's discriminant
        scores to the C class centroids of its fold (Algorithm 2)."""
        onehot = (classes[:, None] == torch.arange(num_classes, device=classes.device))
        onehot = onehot.to(self.folds[0][0].dtype)
        fits, tests = self.fit(onehot)                            # (K, N-m, C), (K, m, C)
        y_tr = onehot[self.tr]                                    # (K, N-m, C)
        n_tr = y_tr.shape[1]
        counts = y_tr.sum(dim=1)                                  # (K, C)
        m_mat = self.mm(fits.transpose(1, 2), y_tr) / n_tr
        d_pi = counts / n_tr
        w_half = 1.0 / torch.sqrt(d_pi.clamp(min=_EPS))
        sym = w_half[:, :, None] * m_mat * w_half[:, None, :]
        evals, evecs = torch.linalg.eigh(0.5 * (sym + sym.transpose(1, 2)))
        order = torch.argsort(evals, dim=1, descending=True)[:, 1:]   # drop α² = 1
        a2 = torch.gather(evals, 1, order).clamp(_EPS, 1.0 - _EPS)
        theta = w_half[:, :, None] * torch.gather(
            evecs, 2, order[:, None, :].expand(-1, evecs.shape[1], -1))
        scale = 1.0 / (n_tr ** 0.5 * torch.sqrt(a2 * (1.0 - a2)))
        theta = theta * scale[:, None, :]
        s_tr, s_te = self.mm(fits, theta), self.mm(tests, theta)
        centroids = self.mm(y_tr.transpose(1, 2), s_tr) / counts.clamp(min=1.0)[:, :, None]
        return ((s_te[:, :, None, :] - centroids[:, None, :, :]) ** 2).sum(dim=-1)


def uniform_permutations(seed: int, t: int, n: int, device) -> torch.Tensor:
    """(t, n) int64 rows, each a uniformly random permutation of 0..n-1,
    independent of any program's draw: the order of float64 uniforms from a
    CPU generator seeded with ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    return torch.rand((t, n), generator=gen, dtype=torch.float64).argsort(dim=1).to(device)


def hits(dvals: torch.Tensor, y_te: torch.Tensor) -> torch.Tensor:
    """Correctly classified test trials per label column: (K, m, B) → (B,)."""
    pred = torch.where(dvals >= 0, 1.0, -1.0)
    return (pred == torch.sign(y_te).to(pred.dtype)).sum(dim=(0, 1))
