"""Async serving quickstart: warm-up, pinned plans, streamed permutations.

    PYTHONPATH=src python examples/torch/async_stream.py [--device cpu]

The interactive-analysis story the paper's economics enable (§2.7), on
the One-API surface: a session registers its dataset and warms the engine
once — plan built, pinned, bucketed eval family served once — then many
concurrent coroutines submit Workloads through one async-transport
Client, coalescing in the server's gather window with no new launch
shape, and a long permutation test *streams* its null distribution
chunk by chunk, so the running p-value is watchable long before the last
permutation lands. All engine work runs on the server's one engine
thread, bound to the engine's device (the card by default).
"""

import argparse
import asyncio

import torch

from repro_torch.core import folds as foldlib
from repro_torch.data import synthetic
from repro_torch.serve import Client, CVEngine, EngineConfig, Workload


async def main(dev):
    n, p, num_classes = 96, 1536, 3
    x, yc = synthetic.make_classification(0, n, p, num_classes=num_classes,
                                          class_sep=2.5, device=dev)
    y = torch.where(yc % 2 == 0, -1.0, 1.0).to(x.dtype)

    engine = CVEngine(EngineConfig(device=dev))
    data = engine.register(x, foldlib.kfold(n, 6, seed=0, device=dev), lam=1.0)
    info = engine.warmup(
        data,
        tasks=("binary", "ridge", "multiclass", "permutation"),
        buckets=(1, 2, 4, 8, 64),
        num_classes=num_classes,
        pin=True,
    )
    compiles_after_warmup = info["compiles"]
    print(
        f"warmup: plan built + pinned, {compiles_after_warmup} programs "
        f"compiled for buckets {info['buckets']}"
    )

    async with Client(engine, transport="async", gather_window_ms=3.0,
                      stream_chunk=64) as client:
        # Eight concurrent clients; same plan, coalesced padded evals.
        async def one_client(cid):
            r1 = await client.submit(
                Workload(kind="cv", dataset=data, y=torch.roll(y, cid))
            )
            r2 = await client.submit(
                Workload(kind="cv", dataset=data, y=yc,
                         estimator="multiclass", num_classes=num_classes)
            )
            return float(r1.score), float(r2.score)

        scores = await asyncio.gather(*(one_client(c) for c in range(8)))
        mean_bin = sum(s[0] for s in scores) / len(scores)
        print(
            f"8 async clients: mean binary acc {mean_bin:.3f}, "
            f"{client.server.batches_served} micro-batches, "
            f"recompiles: {engine.compile_count() - compiles_after_warmup}"
        )

        # Stream a 256-draw permutation null in 64-draw chunks: the
        # running p-value converges while the test is still in flight.
        observed = None
        perm = Workload(kind="permutation", dataset=data, y=y, n_perm=256, seed=7)
        async for ev in client.stream(perm):
            if ev.kind == "observed":
                observed = ev.payload
            elif ev.kind == "null":
                null_so_far = int((ev.payload >= observed).sum())
                print(f"  null {ev.done:3d}/{ev.total}: +{null_so_far} draws ≥ observed")
            elif ev.kind == "done":
                print(f"streamed permutation test: p = {float(ev.payload.p):.4f}")

    s = engine.stats()
    print(
        f"engine: {s['plans_built']} plan build, {s['pinned']} pinned, "
        f"{s['hits']} cache hits, {s['compiles']} compiled programs"
    )


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    asyncio.run(main(ap.parse_args().device))
