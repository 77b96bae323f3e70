"""Streaming-data quickstart: mutable versioned datasets.

    PYTHONPATH=src python examples/torch/streaming_quickstart.py [--device cpu]

An online session: register a dataset once, then keep serving while new
trials arrive and old ones age out. ``client.append`` / ``client.retire``
(and ``Workload(kind="update")``) advance the dataset to version n+1 via
a rank-k correction of the cached CV plan — no Gram rebuild, no new
launch shape — while version n stays servable until released. The stats
at the end show one plan *build* for the whole session, the rest were
incremental *updates*, and the compile count stays flat once warm.
"""

import argparse

import numpy as np
import torch

from repro_torch.core import folds as foldlib
from repro_torch.data import synthetic
from repro_torch.serve import Client, CVEngine, EngineConfig, Workload


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    dev = ap.parse_args().device

    n, p, k = 96, 1536, 6
    x, yc = synthetic.make_classification(0, n, p, num_classes=2, class_sep=2.5, device=dev)
    y = torch.where(yc % 2 == 0, -1.0, 1.0).double().cpu().numpy()

    client = Client(CVEngine(EngineConfig(device=dev)))
    handle = client.register(x, foldlib.kfold(n, k, seed=0, device=dev), lam=1.0)
    first = client.submit(Workload(kind="cv", dataset=handle, y=y))
    print(f"v0: N={handle.n}, CV accuracy {float(first.score):.3f}")

    # -- new trials arrive: append one row per fold (round-robin) ---------
    rng = np.random.default_rng(1)
    x_new = rng.normal(size=(k, p))
    handle = client.append(handle, x_new)
    y = np.concatenate([y, np.where(np.arange(k) % 2 == 0, -1.0, 1.0)])
    resp = client.submit(Workload(kind="cv", dataset=handle, y=y))
    print(f"v{handle.version}: N={handle.n} (+{handle.n_appended} appended), "
          f"CV accuracy {float(resp.score):.3f}")

    # -- steady state: slide the window (retire oldest, append fresh) -----
    compiles_warm = client.stats()["compiles"]
    for step in range(3):
        rec = client.engine.dataset_record(handle)
        drop = rec.folds.te_idx[:, 0].cpu().numpy()
        keep = np.setdiff1d(np.arange(handle.n), drop)
        x_new = rng.normal(size=(k, p))
        # one kind="update" workload = retire + append in one rank-k move
        upd = client.submit(Workload(kind="update", dataset=handle,
                                     x=x_new, drop_idx=drop))
        handle = upd.handle
        y = np.concatenate([y[keep], np.where(np.arange(k) % 2 == 0, -1.0, 1.0)])
        resp = client.submit(Workload(kind="cv", dataset=handle, y=y))
        print(f"v{handle.version}: window advanced (rank {upd.rank}), "
              f"CV accuracy {float(resp.score):.3f}")

    s = client.stats()
    print(f"engine: {s['plans_built']} plan build, {s['plans_updated']} "
          f"incremental updates, {len(client.datasets())} versions "
          f"registered, {s['compiles'] - compiles_warm} recompiles once warm")
    assert s["plans_built"] == 1 and s["plans_updated"] == 4
    assert s["compiles"] == compiles_warm, "window advances must stay compile-flat"

    # -- old versions are refcounted: release what the window left behind -
    for info in client.datasets():
        h = info["handle"]
        if h.key != handle.key:
            client.engine.release(h)
    print(f"released stale versions; {len(client.datasets())} dataset "
          f"resident (v{handle.version})")


if __name__ == "__main__":
    main()
