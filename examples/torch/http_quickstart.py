"""Over-the-wire quickstart: the Workload API through the HTTP/SSE edge.

    PYTHONPATH=src python examples/torch/http_quickstart.py [--device cpu]

The same session as ``serve_quickstart``, but across a real TCP
boundary: an :class:`repro_torch.serve.HTTPEdge` serves the engine on
loopback (here on a background thread; in production via
``python -m repro_torch.launch.serve_cv --http PORT --warmup --pin``), and
an :class:`repro_torch.serve.HTTPClient` — a constructor-for-constructor
mirror of the in-process ``Client`` — registers the dataset, submits a
mixed Workload batch as JSON, and watches a permutation test stream its
null distribution as Server-Sent Events. Results decode into the same
response dataclasses the in-process path returns (CPU tensors),
bit-identical to it. The engine runs on the card by default.
"""

import argparse

import torch

from repro_torch.core import folds as foldlib
from repro_torch.data import synthetic
from repro_torch.serve import Client, CVEngine, EdgeThread, EngineConfig, HTTPClient, Workload


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    dev = ap.parse_args().device

    n, p, num_classes = 96, 1536, 3
    x, yc = synthetic.make_classification(0, n, p, num_classes=num_classes,
                                          class_sep=2.5, device=dev)
    y = torch.where(yc % 2 == 0, -1.0, 1.0).to(x.dtype)
    folds = foldlib.kfold(n, 6, seed=0, device=dev)

    engine = CVEngine(EngineConfig(device=dev))
    with EdgeThread(engine, stream_chunk=64) as edge:
        print(f"edge up at {edge.url} (engine on {engine.device})")
        client = HTTPClient(edge.url)

        # register once over the wire; workloads then carry the handle
        data = client.register(x, (folds.te_idx, folds.tr_idx), lam=1.0)
        print(f"registered dataset: N={data.n}, P={data.p} -> handle {data.key[0][:8]}")

        responses = client.gather([
            Workload(kind="cv", dataset=data, y=y),
            Workload(kind="cv", dataset=data, y=y, estimator="ridge"),
            Workload(kind="cv", dataset=data, y=yc,
                     estimator="multiclass", num_classes=num_classes),
        ])
        for resp in responses:
            print(f"  {resp.task:>10s} CV over the wire: score {float(resp.score):.3f}")

        # the wire is a transport, not a second implementation
        local = Client(engine).submit(Workload(kind="cv", dataset=data, y=y))
        assert torch.equal(local.values.cpu(), responses[0].values)
        print("wire result is bit-identical to the in-process Client")

        # SSE: a 256-draw permutation null streams in 64-draw chunks
        observed = None
        perm = Workload(kind="permutation", dataset=data, y=y, n_perm=256, seed=7)
        for ev in client.stream(perm):
            if ev.kind == "observed":
                observed = ev.payload
            elif ev.kind == "null":
                ge = int((ev.payload >= observed).sum())
                print(f"  null {ev.done:3d}/{ev.total}: +{ge} draws ≥ observed")
            elif ev.kind == "done":
                print(f"streamed permutation test: p = {float(ev.payload.p):.4f}")

        s = client.stats()
        print(f"edge: {s['edge']['http_requests']} http requests, "
              f"{s['edge']['http_streams']} streams, "
              f"{s['engine']['plans_built']} plan build, "
              f"{s['engine']['compiles']} compiled programs")
        client.close()


if __name__ == "__main__":
    main()
