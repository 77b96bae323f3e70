"""Stand up the analytical-CV serving engine and measure throughput.

    PYTHONPATH=src python -m repro_torch.launch.serve_cv --requests 64
    PYTHONPATH=src python -m repro_torch.launch.serve_cv --data eeg --clients 4
    PYTHONPATH=src python -m repro_torch.launch.serve_cv --rsa --conditions 8
    PYTHONPATH=src python -m repro_torch.launch.serve_cv --warmup --pin --async 8
    PYTHONPATH=src python -m repro_torch.launch.serve_cv --record-traffic t.json
    PYTHONPATH=src python -m repro_torch.launch.serve_cv --warmup-from t.json
    PYTHONPATH=src python -m repro_torch.launch.serve_cv --http 8000 --warmup --pin
    PYTHONPATH=src python -m repro_torch.launch.serve_cv --window 16
    PYTHONPATH=src python -m repro_torch.launch.serve_cv --device cpu

Builds a :class:`repro_torch.serve.CVEngine` on the card (``--device``,
default ``cuda``; ``cpu`` for the plain versions) fronted by the unified
:class:`repro_torch.serve.Client`, registers a small fleet of datasets
(synthetic hypersphere-classification or EEG-like windowed features) as
:class:`~repro_torch.serve.DatasetHandle`\\ s, and plays a mixed
:class:`~repro_torch.serve.Workload` stream against it — binary-LDA CV,
ridge CV, multi-class CV, permutation tests, and λ-tuning — first cold
(plans built, launch shapes first seen), then warm (everything cached).
With ``--rsa`` the stream becomes RSA traffic instead: cross-validated
RDMs (pairwise-contrast and confusion), scored against model RDMs with
condition-permutation nulls, all riding the same cached plans and
coalesced label batches. With ``--clients > 1`` the same stream is
replayed through a thread-transport Client so concurrent submitters
coalesce onto shared micro-batches; with ``--async N`` through an
async-transport Client (N coroutine clients), followed by a streamed
permutation workload printing its null chunks as they land. ``--warmup``
pre-builds every plan and serves the bucketed eval family once before
the first timed pass (``--pin`` additionally pins the warmed plans
against eviction). ``--record-traffic FILE`` dumps the (task, bucket) set
the session served; ``--warmup-from FILE`` replays a recorded set at
boot, warming the per-workload shapes yesterday's traffic needed. Reports
requests/s and the engine's cache / launch-shape statistics
("compiled programs" counts the engine's distinct eval input signatures,
the eager counterpart of the reference's jit cache entries).

Data come from this package's generators (``repro_torch.data``, seeded
with ``--seed`` + the dataset index), not from ``jax.random``: the printed
numbers differ from the reference CLI's because the draws do.

``--plan-store DIR`` adds the durable plan tier: cache misses read
verified plans from DIR before rebuilding, and with ``--save-plans``
every fresh build is persisted (write-behind) for the next boot. The
warm-boot sequence::

    serve_cv --http 0 --plan-store X --warmup-from traffic.json --save-plans

reaches 0 plan builds. The reference's ``--compilation-cache`` (jax's
persistent XLA cache) has no counterpart: this package compiles no
programs at run time, and its CUDA kernels build once per source hash
into ``src/repro_torch/_build/``, kept across boots.

With ``--http PORT`` the process becomes a network service instead of a
local replay: datasets register, warm-up runs as requested, then a
:class:`repro_torch.serve.HTTPEdge` serves ``Workload`` JSON over HTTP —
batched results at ``POST /v1/workloads``, SSE progress streams at
``POST /v1/workloads/stream``, wire-side dataset registration at ``POST
/v1/datasets`` — until interrupted (SIGINT or SIGTERM; write-behind plan
saves are flushed before exit). ``--record-traffic`` composes: the
(task, bucket) set observed *over the wire* is dumped on shutdown.
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import os
import threading
import time

import numpy as np
import torch

from repro_torch import rsa
from repro_torch.core import folds as foldlib
from repro_torch.data import eeg, synthetic
from repro_torch.serve import Client, CVEngine, EngineConfig, TrafficLog, Workload
from repro_torch.serve.workload import _host


def build_workloads(args, client):
    """Alternating binary (C=2) and multi-class (C=3) datasets, mixed
    workload stream: CV (binary/ridge/multiclass), permutations, tuning.
    Datasets register once; workloads carry handles. Returns
    (workloads, datasets)."""
    dev = client.engine.device
    datasets = []
    for d in range(args.datasets):
        num_classes = 2 if d % 2 == 0 else 3
        seed = args.seed + d
        if args.data == "eeg":
            ds = eeg.simulate_subject(seed, n_trials=args.n, num_classes=num_classes,
                                      dtype=torch.float64, device=dev)
            x, y_int = eeg.windowed_features(ds, 200.0), ds.y
            del ds
        else:
            x, y_int = synthetic.make_classification(seed, args.n, args.p,
                                                     num_classes=num_classes,
                                                     class_sep=2.0, device=dev)
        n = int(x.shape[0])
        handle = client.register(x, foldlib.kfold(n, args.k, seed=d, device=dev), args.lam)
        y_bin = torch.where(y_int % 2 == 0, -1.0, 1.0).to(x.dtype)
        datasets.append((handle, x, y_bin, y_int, num_classes))

    workloads = []
    for i in range(args.requests):
        handle, x, y_bin, y_int, c = datasets[i % len(datasets)]
        slot = i % 8
        if slot == 7:
            if c > 2:
                workloads.append(Workload(
                    kind="permutation", dataset=handle, y=y_int,
                    estimator="multiclass", num_classes=c,
                    n_perm=args.perm, seed=i))
            else:
                workloads.append(Workload(
                    kind="permutation", dataset=handle, y=y_bin,
                    n_perm=args.perm, seed=i))
        elif slot == 6:
            workloads.append(Workload(kind="tune", x=x, y=y_bin))
        elif slot in (4, 5) and c > 2:
            workloads.append(Workload(kind="cv", dataset=handle, y=y_int,
                                      estimator="multiclass", num_classes=c))
        elif slot == 3:
            workloads.append(Workload(kind="cv", dataset=handle, y=y_bin,
                                      estimator="ridge"))
        else:
            workloads.append(Workload(kind="cv", dataset=handle, y=y_bin,
                                      estimator="binary"))
    return workloads, datasets


def build_rsa_workloads(args, client):
    """RSA stream: C-condition datasets, RDM workloads alternating pairwise
    dissimilarities and confusion contrasts, scored against model RDMs."""
    dev = client.engine.device
    c = args.conditions
    datasets = []
    for d in range(args.datasets):
        x, y_cond = synthetic.make_classification(args.seed + d, args.n, args.p,
                                                  num_classes=c, class_sep=2.0, device=dev)
        handle = client.register(
            x, foldlib.stratified_kfold(y_cond, args.k, seed=d, device=dev), args.lam)
        mu = rsa.condition_means(x, y_cond, c)
        models = torch.stack([rsa.euclidean_rdm(mu), rsa.ring_rdm(c, x.dtype, device=dev)])
        datasets.append((handle, x, y_cond, models, c))

    workloads = []
    for i in range(args.requests):
        handle, _x, y_cond, models, _c = datasets[i % len(datasets)]
        slot = i % 4
        if slot == 3:
            workloads.append(Workload(kind="rsa", dataset=handle, y=y_cond,
                                      num_classes=c, contrast="multiclass",
                                      model_rdms=models, n_perm=args.perm,
                                      seed=i))
        elif slot == 2:
            workloads.append(Workload(kind="rsa", dataset=handle, y=y_cond,
                                      num_classes=c,
                                      dissimilarity="contrast",
                                      adjust_bias=False))
        else:
            workloads.append(Workload(kind="rsa", dataset=handle, y=y_cond,
                                      num_classes=c, model_rdms=models,
                                      n_perm=args.perm, seed=i))
    return workloads, datasets


def warmup_engine(engine, args, datasets):
    """Pre-build (and optionally pin) every plan; serve every eval bucket once."""
    t0 = time.perf_counter()
    small = (1, 2, 4, 8, 16)
    for entry in datasets:
        handle = entry[0]
        if args.rsa:
            c = args.conditions
            n_pairs = c * (c - 1) // 2
            # same-plan RSA workloads coalesce: cover up to two requests'
            # worth of contrast columns in one padded batch
            engine.warmup(handle, tasks=("rsa", "multiclass"),
                          buckets=small + (n_pairs, 2 * n_pairs, args.perm),
                          num_classes=c, num_model_rdms=2, pin=args.pin)
            # the stream's slot-2 variant: continuous contrast, no bias adjust
            engine.warmup(handle, tasks=("rsa",), buckets=(n_pairs,),
                          num_classes=c, dissimilarity="contrast",
                          adjust_bias=False)
        else:
            c = entry[4]
            tasks = ("binary", "ridge", "permutation")
            if c > 2:
                tasks = tasks + ("multiclass",)
            engine.warmup(handle, tasks, buckets=small + (args.perm,),
                          num_classes=c, pin=args.pin)
    t_warm = time.perf_counter() - t0
    s = engine.stats()
    print(f"[serve_cv] warmup: {t_warm:.3f}s, {s['plans_built']} plans built"
          f" ({s['pinned']} pinned), {s['compiles']} programs compiled", flush=True)


def warmup_from_traffic(engine, path, datasets, pin):
    """Boot-time warm-up from a recorded (task, bucket) traffic set."""
    log = TrafficLog.load(path)
    t0 = time.perf_counter()
    for entry in datasets:
        log.replay(engine, entry[0], pin=pin)
    t_warm = time.perf_counter() - t0
    s = engine.stats()
    print(f"[serve_cv] warmup-from {path}: {len(log)} recorded entries, "
          f"{t_warm:.3f}s, {s['plans_built']} plans built "
          f"({s['pinned']} pinned), {s['compiles']} programs compiled", flush=True)


async def replay_async(engine, workloads, n_clients, perm_demo=None):
    """Replay the stream through an async-transport Client with N coroutine
    clients, then stream one permutation workload chunk by chunk. Returns
    the replay's recompiles (new launch shapes)."""
    per_client = -(-len(workloads) // n_clients)
    results = [None] * len(workloads)
    compiles0 = engine.compile_count()
    async with Client(engine, transport="async", max_batch=per_client) as client:

        async def one_client(cid):
            lo = cid * per_client
            for j in range(lo, min(lo + per_client, len(workloads))):
                results[j] = await client.submit(workloads[j])

        t0 = time.perf_counter()
        await asyncio.gather(*(one_client(c) for c in range(n_clients)))
        t_async = time.perf_counter() - t0
        recompiles = engine.compile_count() - compiles0
        print(f"[serve_cv] async ({n_clients} clients): {t_async:.3f}s "
              f"({len(workloads) / t_async:.1f} req/s) in "
              f"{client.server.batches_served} micro-batches, "
              f"recompiles on async replay: {recompiles}")

        if perm_demo is not None:
            t0 = time.perf_counter()
            async for ev in client.stream(perm_demo):
                if ev.kind == "null":
                    print(f"[serve_cv]   stream: {ev.done}/{ev.total} null "
                          f"draws at {time.perf_counter() - t0:.3f}s")
                elif ev.kind == "done":
                    print(f"[serve_cv]   stream: done, p = "
                          f"{float(ev.payload.p):.4f}")
    assert all(r is not None for r in results)
    return recompiles


def run_window(client, args, datasets):
    """Sliding-window mode (``--window N``): the streaming steady state.

    Advances the first dataset N times — each step retires one test row
    per fold (the oldest slots) and appends equally many fresh rows, so
    the sample count, fold geometry, and therefore every eval launch
    shape stay fixed — and serves a binary-CV workload against each new
    version. Dataset versions march 1..N while plans advance by rank-k
    correction (``kind="update"`` → :meth:`CVEngine.update_dataset`), so
    once the first step is served the compile count must stay flat: the
    loop prints per-step update/CV latency and the compile delta.
    """
    engine = client.engine
    handle, x, y_bin, _y_int, _c = datasets[0]
    y = _host(y_bin)
    gen = torch.Generator(device=engine.device)
    gen.manual_seed(args.seed + 1_000_003)
    upd_times, cv_times = [], []
    compiles0 = None
    for step in range(args.window):
        rec = engine.dataset_record(handle)
        n = int(rec.x.shape[0])
        drop = _host(rec.folds.te_idx)[:, 0]  # oldest slot per fold
        x_new = torch.randn((drop.size, int(rec.x.shape[1])), generator=gen,
                            dtype=rec.x.dtype, device=engine.device)
        coin = torch.rand((drop.size,), generator=gen, device=engine.device) < 0.5
        t0 = time.perf_counter()
        resp = client.submit(Workload(kind="update", dataset=handle,
                                      x=x_new, drop_idx=drop))
        upd_times.append(time.perf_counter() - t0)
        handle = resp.handle
        keep = np.setdiff1d(np.arange(n), drop)
        y = np.concatenate([y[keep], np.where(_host(coin), 1.0, -1.0)])
        t0 = time.perf_counter()
        cv = client.submit(Workload(kind="cv", dataset=handle,
                                    y=torch.as_tensor(y, dtype=rec.x.dtype)))
        cv_times.append(time.perf_counter() - t0)
        if compiles0 is None:
            compiles0 = engine.compile_count()  # after the first warm step
        if step < 3 or step == args.window - 1:
            print(f"[serve_cv]   window step {step + 1}/{args.window}: "
                  f"v{resp.version}, rank {resp.rank}, update "
                  f"{upd_times[-1] * 1e3:.1f}ms, cv {cv_times[-1] * 1e3:.1f}ms, "
                  f"score {float(cv.score):.3f}")
    steady_upd = sorted(upd_times[1:] or upd_times)[len(upd_times[1:] or upd_times) // 2]
    steady_cv = sorted(cv_times[1:] or cv_times)[len(cv_times[1:] or cv_times) // 2]
    recompiles = engine.compile_count() - compiles0
    s = engine.stats()
    print(f"[serve_cv] window: {args.window} advances, steady-state update "
          f"p50 {steady_upd * 1e3:.1f}ms, cv p50 {steady_cv * 1e3:.1f}ms, "
          f"plans updated: {s['plans_updated']}, "
          f"recompiles after first step: {recompiles}")
    if recompiles:
        print("[serve_cv] WARNING: sliding window recompiled — fold "
              "geometry was not preserved")
    return recompiles


def start_profile(profile_dir, device):
    """Begin a torch.profiler capture; returns the profiler, or None.

    Failures degrade to a warning — profiling is an extra, never a
    prerequisite for serving.
    """
    if not profile_dir:
        return None
    try:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=activities)
        prof.start()
        print(f"[serve_cv] profiling -> {profile_dir}")
        return prof
    except Exception as e:  # noqa: BLE001 - best-effort tooling
        print(f"[serve_cv] warning: profiler failed to start: {e}")
        return None


def stop_profile(prof, profile_dir):
    """End the capture and write it as a Chrome trace (Perfetto reads it)."""
    if prof is None:
        return
    try:
        prof.stop()
        os.makedirs(profile_dir, exist_ok=True)
        path = os.path.join(profile_dir, "serve_cv_trace.json")
        prof.export_chrome_trace(path)
        print(f"[serve_cv] profile capture complete -> {path}")
    except Exception as e:  # noqa: BLE001 - best-effort tooling
        print(f"[serve_cv] warning: profiler failed to stop: {e}")


def print_stage_summary(engine):
    """Per-stage p50/p95 over the tracer ring (with --metrics)."""
    summary = engine.tracer.summary()
    if not summary:
        print("[serve_cv] no traces recorded")
        return
    print("[serve_cv] stage latency (over last "
          f"{len(engine.tracer.last(engine.tracer.ring_size))} traces):")
    for stage, s in summary.items():
        print(f"[serve_cv]   {stage:<12} n={s['count']:<5} "
              f"p50={s['p50_s'] * 1e3:8.3f}ms  p95={s['p95_s'] * 1e3:8.3f}ms")


def serve_http(engine, args, record):
    """Expose the engine over the HTTP/SSE edge until interrupted."""
    import signal

    from repro_torch.serve.http import HTTPEdge

    # Process supervisors (systemd, docker stop, k8s) stop services with
    # SIGTERM. Until the loop runs, route it through KeyboardInterrupt so the
    # shutdown path — the store flush and the --record-traffic dump below —
    # runs either way.
    signal.signal(signal.SIGTERM, signal.default_int_handler)

    async def run_edge():
        # Once the loop runs, SIGINT and SIGTERM become loop callbacks. An
        # exception raised asynchronously inside the loop can land between
        # a transport's close and its server's bookkeeping, and then
        # Server.wait_closed() waits forever for a connection already gone.
        loop = asyncio.get_running_loop()
        stop = asyncio.Event()
        for sig in (signal.SIGINT, signal.SIGTERM):
            loop.add_signal_handler(sig, stop.set)
        edge = HTTPEdge(engine, host=args.http_host, port=args.http,
                        record=record)
        await edge.start()
        print(f"[serve_cv] http edge listening on {edge.url} "
              f"(POST /v1/workloads, /v1/workloads/stream, /v1/datasets; "
              f"GET /v1/stats, /v1/datasets, /v1/metrics, /v1/trace, "
              f"/healthz)", flush=True)
        try:
            await stop.wait()
        finally:
            await edge.stop()

    try:
        with contextlib.suppress(KeyboardInterrupt):
            asyncio.run(run_edge())
        print("[serve_cv] http edge shut down", flush=True)
    finally:
        # The edge's stop path flushes too, but a KeyboardInterrupt can
        # land before/after it — make write-behind durability explicit.
        engine.flush_store()
        if args.record_traffic and record is not None:
            record.save(args.record_traffic)
            print(f"[serve_cv] recorded {len(record)} (task, bucket) "
                  f"entries -> {args.record_traffic}", flush=True)


def _ready(engine):
    """Wait for the card: results are tensors on the engine's device."""
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="where the engine runs: cuda (default) or cpu")
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--data", default="synthetic", choices=("synthetic", "eeg"))
    ap.add_argument("--datasets", type=int, default=3,
                    help="distinct datasets cycled through the stream")
    ap.add_argument("--n", type=int, default=96, help="samples per dataset")
    ap.add_argument("--p", type=int, default=768,
                    help="features (synthetic only; eeg fixes P=1900)")
    ap.add_argument("--k", type=int, default=6, help="CV folds")
    ap.add_argument("--lam", type=float, default=1.0)
    ap.add_argument("--perm", type=int, default=64,
                    help="permutations per permutation workload")
    ap.add_argument("--clients", type=int, default=0,
                    help="if > 1, replay warm through this many threads")
    ap.add_argument("--async", type=int, default=0, dest="async_clients",
                    metavar="N", help="if > 1, replay warm through the "
                    "asyncio transport with N coroutine clients + stream demo")
    ap.add_argument("--warmup", action="store_true",
                    help="pre-build plans + serve every eval bucket once "
                    "before the first timed pass")
    ap.add_argument("--pin", action="store_true",
                    help="with --warmup/--warmup-from: pin the warmed "
                    "plans (never LRU-evicted)")
    ap.add_argument("--record-traffic", metavar="FILE", default=None,
                    help="dump the served (task, bucket) set as JSON")
    ap.add_argument("--warmup-from", metavar="FILE", default=None,
                    help="replay a recorded traffic set at boot "
                    "(pre-builds plans + serves exactly the launch "
                    "shapes that traffic needed)")
    ap.add_argument("--http", type=int, default=None, metavar="PORT",
                    help="serve the Workload API over HTTP/SSE on this "
                    "port (after any --warmup/--warmup-from) instead of "
                    "replaying a local stream; 0 picks a free port")
    ap.add_argument("--http-host", default="127.0.0.1",
                    help="bind address for --http (default loopback)")
    ap.add_argument("--metrics", action="store_true",
                    help="enable request tracing + per-stage latency "
                    "histograms (served at GET /v1/metrics and /v1/trace "
                    "with --http; printed as a p50/p95 stage summary "
                    "otherwise)")
    ap.add_argument("--trace-ring", type=int, default=256, metavar="N",
                    help="finished traces kept for /v1/trace and the "
                    "stage summary (with --metrics; default 256)")
    ap.add_argument("--profile-dir", metavar="DIR", default=None,
                    help="capture a torch.profiler trace of warm-up plus "
                    "the timed passes into DIR as a Chrome trace (view "
                    "with Perfetto)")
    ap.add_argument("--plan-store", metavar="DIR", default=None,
                    help="durable plan-store directory: cache misses load "
                    "verified plans from here before rebuilding")
    ap.add_argument("--save-plans", action="store_true",
                    help="with --plan-store: persist every freshly built "
                    "plan (write-behind) for the next boot")
    ap.add_argument("--store-mb", type=int, default=4096,
                    help="plan-store byte budget in MiB (GC evicts oldest "
                    "entries over it; default 4096)")
    ap.add_argument("--cache-mb", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--window", type=int, default=0, metavar="N",
                    help="sliding-window mode: advance the first dataset "
                    "N times (retire the oldest test row per fold, append "
                    "fresh rows via kind=\"update\" rank-k corrections) "
                    "and serve CV against each new version; prints "
                    "steady-state latency and compile flatness")
    ap.add_argument("--rsa", action="store_true",
                    help="serve an RSA workload stream instead of mixed CV")
    ap.add_argument("--conditions", type=int, default=6,
                    help="RSA conditions per dataset (with --rsa)")
    ap.add_argument("--debug-nans", action="store_true",
                    help="check every eval's outputs for NaN / inf and raise "
                    "FloatingPointError naming the evaluator (syncs the "
                    "host per eval; for triaging numeric blowups, not "
                    "serving)")
    return ap


def main(argv=None):
    ap = parser()
    args = ap.parse_args(argv)

    if args.save_plans and not args.plan_store:
        ap.error("--save-plans requires --plan-store DIR")
    if args.window and args.rsa:
        ap.error("--window composes with the mixed-CV stream, not --rsa")

    engine = CVEngine(EngineConfig(
        cache_bytes=args.cache_mb << 20,
        plan_store=args.plan_store,
        save_plans=args.save_plans,
        store_bytes=args.store_mb << 20,
        device=args.device,
    ))
    print(f"[serve_cv] engine on {engine.device}"
          + (f" ({torch.cuda.get_device_name(engine.device)})"
             if engine.device.type == "cuda" else ""), flush=True)
    if args.debug_nans:
        engine.debug_nans = True
        print("[serve_cv] debug-nans on: every eval's outputs checked for NaN / inf")
    if args.plan_store:
        print(f"[serve_cv] plan store -> {args.plan_store} "
              f"({len(engine.store)} entries, "
              f"{engine.store.stats.bytes_in_store / 2**20:.1f} MiB resident"
              f"{', save-plans' if args.save_plans else ', read-only'})")
    if args.metrics:
        engine.enable_tracing(ring=args.trace_ring)
    record = TrafficLog() if args.record_traffic else None
    client = Client(engine, record=record)
    if args.rsa:
        workloads, datasets = build_rsa_workloads(args, client)
        print(f"[serve_cv] RSA mode: {len(workloads)} workloads over "
              f"{args.datasets} datasets, C={args.conditions}, λ={args.lam}, "
              f"K={args.k}, T={args.perm}")
    else:
        workloads, datasets = build_workloads(args, client)
        print(f"[serve_cv] {len(workloads)} workloads over {args.datasets} "
              f"datasets ({args.data}), λ={args.lam}, K={args.k}, "
              f"T={args.perm}", flush=True)

    # Profile window: warm-up (plan builds, first launches) plus the timed
    # passes.
    profiling = start_profile(args.profile_dir, engine.device)

    if args.warmup_from:
        warmup_from_traffic(engine, args.warmup_from, datasets, args.pin)
    if args.warmup:
        warmup_engine(engine, args, datasets)

    if args.http is not None:
        stop_profile(profiling, args.profile_dir)
        serve_http(engine, args, record)
        return {"engine": engine}

    if args.window:
        recompiles = run_window(client, args, datasets)
        stop_profile(profiling, args.profile_dir)
        return {"engine": engine, "window_recompiles": recompiles}

    t0 = time.perf_counter()
    responses = client.gather(workloads)
    _ready(engine)
    t_cold = time.perf_counter() - t0

    compiles_after_cold = engine.compile_count()
    t0 = time.perf_counter()
    responses = client.gather(workloads)
    _ready(engine)
    t_warm = time.perf_counter() - t0
    warm_recompiles = engine.compile_count() - compiles_after_cold
    stop_profile(profiling, args.profile_dir)

    print(f"[serve_cv] cold: {t_cold:.3f}s ({len(workloads)/t_cold:.1f} req/s)"
          f"   warm: {t_warm:.3f}s ({len(workloads)/t_warm:.1f} req/s)"
          f"   speedup {t_cold/t_warm:.1f}x, "
          f"recompiles on warm replay: {warm_recompiles}")
    out = {"engine": engine, "responses": responses, "warm_recompiles": warm_recompiles}

    if args.clients > 1:
        per_client = -(-len(workloads) // args.clients)
        with Client(engine, transport="thread", max_batch=per_client) as tclient:
            results = [None] * len(workloads)

            def one_client(cid):
                lo = cid * per_client
                futs = [(j, tclient.submit(workloads[j]))
                        for j in range(lo, min(lo + per_client, len(workloads)))]
                for j, f in futs:
                    results[j] = f.result(timeout=600)

            t0 = time.perf_counter()
            threads = [threading.Thread(target=one_client, args=(c,))
                       for c in range(args.clients)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            t_threaded = time.perf_counter() - t0
            print(f"[serve_cv] threaded ({args.clients} clients): "
                  f"{t_threaded:.3f}s ({len(workloads)/t_threaded:.1f} req/s) "
                  f"in {tclient.server.batches_served} micro-batches")
        assert all(r is not None for r in results)
        out["threaded"] = results

    if args.async_clients > 1:
        demo = None
        if not args.rsa:
            handle, y_bin = datasets[0][0], datasets[0][2]
            demo = Workload(kind="permutation", dataset=handle, y=y_bin,
                            n_perm=4 * args.perm, seed=99)
        out["async_recompiles"] = asyncio.run(
            replay_async(engine, workloads, args.async_clients, perm_demo=demo))

    if args.record_traffic:
        record.save(args.record_traffic)
        print(f"[serve_cv] recorded {len(record)} (task, bucket) entries "
              f"-> {args.record_traffic}")

    engine.flush_store()
    stats = engine.stats()
    if args.plan_store:
        print(f"[serve_cv] plan store: {stats['store_hits']} hits / "
              f"{stats['store_misses']} misses / {stats['store_writes']} "
              f"writes, {stats['store_bytes'] / 2**20:.1f} MiB on disk")
    print(f"[serve_cv] cache: {stats['hits']} hits / {stats['misses']} misses "
          f"/ {stats['evictions']} evictions / {stats['pinned']} pinned, "
          f"{stats['bytes_in_use'] / 2**20:.1f} MiB in use "
          f"(budget {stats['byte_budget'] / 2**20:.0f} MiB)")
    print(f"[serve_cv] plans built: {stats['plans_built']}, "
          f"labels evaluated: {stats['labels_evaluated']}, "
          f"compiled programs: {stats['compiles']}, "
          f"RDM cache hits: {stats['rdm_hits']}")
    scored = [float(r.score) for r in responses if hasattr(r, "score")]
    if scored:
        print(f"[serve_cv] mean CV score over {len(scored)} CV workloads: "
              f"{sum(scored)/len(scored):.3f}")
    rsa_scored = [r for r in responses
                  if hasattr(r, "model_scores") and r.model_scores is not None]
    if rsa_scored:
        best = [float(r.model_scores.max()) for r in rsa_scored]
        sig = [float(r.p.min()) for r in rsa_scored if r.p is not None]
        print(f"[serve_cv] RSA: best-model score mean "
              f"{sum(best)/len(best):.3f} over {len(rsa_scored)} scored "
              f"workloads" + (f", min p {min(sig):.4f}" if sig else ""))
    if args.metrics:
        print_stage_summary(engine)
    return out


if __name__ == "__main__":
    main()
