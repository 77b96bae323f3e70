"""Serving-engine quickstart: one registered dataset, many workloads.

    PYTHONPATH=src python examples/torch/serve_quickstart.py [--device cpu]

A neuroimaging-flavoured session on the One-API surface: register the
dataset once (`client.register` -> DatasetHandle; the feature matrix is
never re-shipped), then a stream of Workload specs against the handle —
binary CV, a permutation test, multi-class CV, ridge-λ tuning. The engine
builds the hat matrix + fold factorisations ONCE (first workload) and
serves everything else from the cached plan; the stats at the end show a
single plan build for the whole session. On the card by default.
"""

import argparse

import torch

from repro_torch.core import folds as foldlib
from repro_torch.data import synthetic
from repro_torch.serve import Client, CVEngine, EngineConfig, Workload


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    dev = ap.parse_args().device

    n, p, num_classes = 96, 1536, 3
    x, yc = synthetic.make_classification(0, n, p, num_classes=num_classes,
                                          class_sep=2.5, device=dev)
    y = torch.where(yc % 2 == 0, -1.0, 1.0).to(x.dtype)        # binary contrast

    client = Client(CVEngine(EngineConfig(device=dev)))   # sync transport
    data = client.register(x, foldlib.kfold(n, 6, seed=0, device=dev), lam=1.0)

    responses = client.gather([
        Workload(kind="cv", dataset=data, y=y),
        Workload(kind="permutation", dataset=data, y=y, n_perm=200, seed=1),
        Workload(kind="cv", dataset=data, y=yc, estimator="multiclass",
                 num_classes=num_classes),
        Workload(kind="permutation", dataset=data, y=yc,
                 estimator="multiclass", num_classes=num_classes,
                 n_perm=200, seed=2),
        Workload(kind="tune", x=x, y=y),
    ])

    cv_bin, perm_bin, cv_mc, perm_mc, tune = responses
    print(f"binary CV accuracy      : {float(cv_bin.score):.3f} "
          f"(p = {float(perm_bin.p):.4f}, T = {perm_bin.null.shape[0]})")
    print(f"multi-class CV accuracy : {float(cv_mc.score):.3f} "
          f"(p = {float(perm_mc.p):.4f})")
    print(f"tuned ridge λ (exact LOO): {float(tune.result.best_lambda):.3g}")
    (info,) = client.datasets()
    print(f"dataset: N={info['n']} P={info['p']}, served {info['served']} "
          f"plan resolutions, resident={info['resident']}")
    s = client.stats()
    print(f"engine: {s['plans_built']} plan build, {s['hits']} cache hits, "
          f"{s['labels_evaluated']} label vectors evaluated, "
          f"{s['compiles']} compiled programs")
    assert s["plans_built"] == 1


if __name__ == "__main__":
    main()
