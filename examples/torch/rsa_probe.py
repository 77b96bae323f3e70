"""Condition-rich RSA served end-to-end by the analytical-CV engine.

The paper's §4.2 application: a Representational Dissimilarity Matrix over
C conditions. `repro_torch.rsa` treats all pairwise contrasts as ONE label
batch against ONE shared CVPlan — the dataset registers once, every
contrast evaluates at O(K·m²), candidate model RDMs are scored with a
condition-permutation null, and a *repeat* of the same workload is served
from the engine's empirical-RDM memo (zero fold solves — watch
`rdm_hits`).

Run:  PYTHONPATH=src python examples/torch/rsa_probe.py [--device cpu]
"""

import argparse
import time

import numpy as np
import torch

from repro_torch import rsa
from repro_torch.core import folds
from repro_torch.data import synthetic
from repro_torch.serve import Client, CVEngine, EngineConfig, Workload

C = 8                 # conditions -> 28 pairwise contrasts, one batch
N_PER_COND = 24
P = 1500              # high-dimensional patterns (P >> N)

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
dev = ap.parse_args().device


def sync():
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


x, y_cond = synthetic.make_classification(0, C * N_PER_COND, P, num_classes=C,
                                          class_sep=1.5, device=dev)

# candidate model RDMs: the condition-mean pattern geometry (the pairdist
# kernel on the card), a circular "ring" structure, and a random control
mu = rsa.condition_means(x, y_cond, C)
ring = rsa.ring_rdm(C, device=dev)
rng = np.random.default_rng(1)
rnd = np.abs(rng.normal(size=(C, C)))
rnd = rnd + rnd.T
np.fill_diagonal(rnd, 0.0)
models = torch.stack([rsa.euclidean_rdm(mu), ring, torch.as_tensor(rnd, device=dev)])
model_names = ["pattern-euclidean", "ring", "random"]

client = Client(CVEngine(EngineConfig(device=dev)))
data = client.register(x, folds.stratified_kfold(y_cond, 6, seed=0, device=dev), lam=1.0)
workload = Workload(kind="rsa", dataset=data, y=y_cond, num_classes=C,
                    model_rdms=models, n_perm=500, seed=0)

t0 = time.perf_counter()
resp = client.submit(workload)
sync()
t_cold = time.perf_counter() - t0
t0 = time.perf_counter()
resp = client.submit(workload)
sync()
t_warm = time.perf_counter() - t0

print(f"{C * (C - 1) // 2} pairwise contrasts at P={P} in one batched "
      f"workload: cold {t_cold:.2f}s, warm {t_warm:.3f}s "
      f"({t_cold / t_warm:.0f}x)")
print("cross-validated RDM (pairwise decodability):")
with np.printoptions(precision=2, suppress=True):
    print(resp.rdm.cpu().numpy())
print(f"mean off-diagonal decodability: "
      f"{float(rsa.upper_triangle(resp.rdm).mean()):.3f}")
print("model-RDM comparison (Spearman, 500-permutation null):")
for name, s, p in zip(model_names, resp.model_scores.tolist(), resp.p.tolist()):
    print(f"  {name:18s} rho={s:+.3f}  p={p:.4f}")

stats = client.stats()
print(f"engine: {stats['plans_built']} plan build(s), "
      f"{stats['hits']} cache hit(s), {stats['compiles']} compiled programs, "
      f"{stats['rdm_hits']} RDM memo hit(s)")
