"""Wire conformance of repro_torch.serve.http on the CPU: the contracts of
the reference's tests/test_http.py, one test each, and the wire across the
two packages.

The HTTP edge is a *transport*, not a second implementation: every byte of
JSON decodes to the exact Workload the in-process Client would construct,
so results are bit-identical, SSE chunks are the same chunks
stream_workload yields (prefix-stable, identical draws to the monolithic
path), and a warm engine serves wire traffic with no new launch shape.
Error paths return structured JSON errors and leave the engine untouched;
per-workload failures surface per entry without aborting siblings.

Across packages the wire format is one: the port's HTTPClient against the
reference's EdgeThread and the reference's HTTPClient against the port's
serve the same workloads, agreeing at ≤ 1e-9 relative (the tolerance of
tests/test_torch_workload.py; permutation nulls are drawn differently by
the two packages, so a permutation test is held by its observed value),
and every error body is byte-equal.
"""

import json
import socket
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import folds as ref_folds
from repro.serve import CVEngine as RefEngine
from repro.serve import EdgeThread as RefEdgeThread
from repro.serve import HTTPClient as RefHTTPClient
from repro.serve import Workload as RefWorkload
from repro.serve import serve as ref_serve
from repro_torch import rsa
from repro_torch.core import folds as foldlib
from repro_torch.serve import (Client, CVEngine, DatasetHandle, DatasetSpec, EdgeThread,
                               EngineConfig, HTTPClient, WireError, Workload, estimators)
from repro_torch.serve.http import assert_responses_equal

N, P, K, LAM = 48, 96, 4, 1.0
TOL = 1e-9


def _engine() -> CVEngine:
    return CVEngine(EngineConfig(device="cpu"))


def _edge(**kw) -> EdgeThread:
    return EdgeThread(_engine(), **kw)


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().double().cpu().numpy()
    return np.asarray(a, dtype=np.float64)


def _close(got, want, tol=TOL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    scale = max(float(np.max(np.abs(want))), 1e-30)
    assert float(np.max(np.abs(got - want))) <= tol * scale


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(0)
    yc = np.arange(N) % 3
    x = rng.normal(size=(N, P))
    x[:, :6] += 1.2 * yc[:, None]
    y = np.where(yc % 2 == 0, -1.0, 1.0)
    f = foldlib.kfold(N, K, seed=1, device="cpu")
    return x, y, yc, f


def _register_over_wire(hclient, problem):
    x, _, _, f = problem
    return hclient.register(x, (f.te_idx.numpy(), f.tr_idx.numpy()), LAM)


def _models():
    ring = rsa.ring_rdm(3, device="cpu").numpy()
    return np.stack([ring, ring * 0.5 + 0.1])


def _workload_matrix(problem, dataset, W=Workload):
    """All five kinds; cv covers every registered estimator."""
    x, y, yc, _ = problem
    q = np.stack([y, -y, np.roll(y, 5)], axis=1)
    return [
        ("cv/binary", W(kind="cv", dataset=dataset, y=y)),
        ("cv/ridge", W(kind="cv", dataset=dataset, y=y, estimator="ridge")),
        ("cv/multiclass", W(kind="cv", dataset=dataset, y=yc,
                            estimator="multiclass", num_classes=3)),
        ("cv/ridge_multi", W(kind="cv", dataset=dataset, y=q, estimator="ridge_multi")),
        ("permutation/binary", W(kind="permutation", dataset=dataset, y=y,
                                 n_perm=12, seed=4)),
        ("permutation/multiclass", W(kind="permutation", dataset=dataset, y=yc,
                                     estimator="multiclass", num_classes=3,
                                     n_perm=10, seed=2)),
        ("rsa/binary+models", W(kind="rsa", dataset=dataset, y=yc, num_classes=3,
                                model_rdms=_models(), n_perm=8, seed=2)),
        ("rsa/multiclass", W(kind="rsa", dataset=dataset, y=yc, num_classes=3,
                             contrast="multiclass")),
        ("tune", W(kind="tune", x=x, y=y)),
        ("grid", W(kind="grid", dataset=dataset, y=y, xs=np.stack([x, x * 1.05]))),
    ]


def _recv_response(s, raw=b""):
    """Read one HTTP response (headers + Content-Length body) off a socket."""
    while True:
        head_part, sep, body_part = raw.partition(b"\r\n\r\n")
        if sep:
            length = 0
            for hline in head_part.split(b"\r\n")[1:]:
                if hline.lower().startswith(b"content-length:"):
                    length = int(hline.split(b":")[1])
            if len(body_part) >= length:
                return raw
        b = s.recv(65536)
        if not b:
            return raw
        raw += b


def _raw(port: int, request: bytes) -> tuple:
    """Send raw request bytes; (status, raw body bytes)."""
    with socket.create_connection(("127.0.0.1", port), timeout=60) as s:
        s.sendall(request)
        raw = _recv_response(s)
    return int(raw.split(b" ", 2)[1]), raw.partition(b"\r\n\r\n")[2]


def _post(payload: bytes, path="/v1/workloads", extra_headers="") -> bytes:
    head = (f"POST {path} HTTP/1.1\r\nHost: t\r\n"
            f"Content-Length: {len(payload)}\r\n{extra_headers}\r\n")
    return head.encode() + payload


def _raw_request(edge, payload: bytes, path="/v1/workloads", extra_headers=""):
    """One hand-rolled POST; returns (status, parsed-or-None body)."""
    status, body = _raw(edge.port, _post(payload, path, extra_headers))
    try:
        return status, json.loads(body.decode())
    except ValueError:
        return status, None


# ---------------------------------------------------------------------------
# The differential harness: HTTP == in-process, bit for bit, compile-flat
# ---------------------------------------------------------------------------


def test_wire_conformance_bit_identical_and_compile_flat(problem):
    """Every workload kind and every registered estimator: the HTTP result
    is bit-identical to the in-process Client result, and a second wire
    pass adds zero launch shapes and zero plan builds to the engine."""
    x, _, _, f = problem
    assert {"binary", "ridge", "multiclass", "ridge_multi"} <= set(estimators())

    ref_client = Client(_engine())
    ref_handle = ref_client.register(x, f, LAM)
    refs = [ref_client.submit(w) for _, w in _workload_matrix(problem, ref_handle)]

    with _edge() as edge, HTTPClient(edge.url) as hc:
        handle = _register_over_wire(hc, problem)
        assert handle.key == ref_handle.key  # same bytes -> same fingerprint
        ws = _workload_matrix(problem, handle)
        got_cold = [hc.submit(w) for _, w in ws]
        for (name, _), a, b in zip(ws, got_cold, refs):
            assert_responses_equal(a, b, name)

        warm_compiles = edge.engine.compile_count()
        warm_plans = edge.engine.stats()["plans_built"]
        got_warm = [hc.submit(w) for _, w in ws]
        assert edge.engine.compile_count() == warm_compiles
        assert edge.engine.stats()["plans_built"] == warm_plans
        for (name, _), a, b in zip(ws, got_warm, refs):
            assert_responses_equal(a, b, name)
        # decoded responses hold CPU tensors
        assert all(isinstance(r.values, torch.Tensor) for r in got_warm[:4])


def test_inline_dataset_spec_over_the_wire(problem):
    """Workloads may also ship the feature matrix inline (DatasetSpec)."""
    x, y, _, f = problem
    ref = Client(_engine()).submit(Workload(kind="cv", dataset=DatasetSpec(x, f, LAM), y=y))
    with _edge() as edge, HTTPClient(edge.url) as hc:
        got = hc.submit(Workload(kind="cv", dataset=DatasetSpec(x, f, LAM), y=y))
        assert_responses_equal(got, ref)


def test_http_batch_gather_matches_in_process(problem):
    """A whole batch through POST /v1/workloads coalesces in the async
    gather window; per-request results match the library answers (≤ 1e-9,
    the concurrent-coalescing tolerance)."""
    x, y, yc, f = problem
    ref_client = Client(_engine())
    ref_handle = ref_client.register(x, f, LAM)
    batch_of = lambda h: [
        Workload(kind="cv", dataset=h, y=np.roll(y, i)) for i in range(3)
    ] + [
        Workload(kind="cv", dataset=h, y=yc, estimator="multiclass", num_classes=3),
        Workload(kind="permutation", dataset=h, y=y, n_perm=12, seed=7),
    ]
    refs = [ref_client.submit(w) for w in batch_of(ref_handle)]
    with _edge() as edge, HTTPClient(edge.url) as hc:
        handle = _register_over_wire(hc, problem)
        got = hc.gather(batch_of(handle))
        assert edge.edge.server.batches_served < len(got)  # actually coalesced
        for a, b in zip(got, refs):
            assert type(a) is type(b)
            for field in ("values", "null"):
                va, vb = getattr(a, field, None), getattr(b, field, None)
                if va is not None:
                    _close(va, vb)


# ---------------------------------------------------------------------------
# SSE streaming: same chunks as stream_workload, ragged concurrent clients
# ---------------------------------------------------------------------------


def test_sse_chunks_bit_identical_ragged_concurrent(problem, monkeypatch):
    """Streamed permutation-null and RSA chunks over concurrent ragged HTTP
    clients are bit-identical to the monolithic responses, prefix by prefix
    — and the chunks really are evaluated chunk-wise on the engine."""
    x, y, yc, f = problem
    chunk = 8
    perms = (12, 20, 28)
    models = _models()

    ref_client = Client(_engine())
    ref_handle = ref_client.register(x, f, LAM)
    mono = {t: ref_client.submit(Workload(kind="permutation", dataset=ref_handle, y=y,
                                          n_perm=t, seed=t))
            for t in perms}
    mono_rsa = ref_client.submit(Workload(kind="rsa", dataset=ref_handle, y=yc, num_classes=3,
                                          model_rdms=models, n_perm=16, seed=3))

    calls = {"n": 0}
    real = CVEngine.null_binary

    def counting(self, *args, **kwargs):
        calls["n"] += 1
        return real(self, *args, **kwargs)

    monkeypatch.setattr(CVEngine, "null_binary", counting)

    with _edge(stream_chunk=chunk) as edge:
        with HTTPClient(edge.url) as hc0:
            handle = _register_over_wire(hc0, problem)
        results = {}

        def one_client(t):
            with HTTPClient(edge.url) as hc:
                w = Workload(kind="permutation", dataset=handle, y=y, n_perm=t, seed=t)
                results[t] = list(hc.stream(w))

        def rsa_client():
            with HTTPClient(edge.url) as hc:
                w = Workload(kind="rsa", dataset=handle, y=yc, num_classes=3,
                             model_rdms=models, n_perm=16, seed=3)
                results["rsa"] = list(hc.stream(w))

        threads = [threading.Thread(target=one_client, args=(t,)) for t in perms]
        threads.append(threading.Thread(target=rsa_client))
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)

        # chunk-wise evaluation actually happened (>= one call per chunk)
        assert calls["n"] >= sum(-(-t // chunk) for t in perms)

        for t in perms:
            events = results[t]
            assert [e.kind for e in events[:2]] == ["plan", "observed"]
            lo = 0
            for ev in events:
                if ev.kind != "null":
                    continue
                block = ev.payload
                assert torch.equal(block, mono[t].null[lo:lo + block.shape[0]])
                lo += block.shape[0]
            final = events[-1].payload
            assert torch.equal(final.null, mono[t].null)
            assert torch.equal(final.p, mono[t].p)

        rsa_events = results["rsa"]
        kinds = [e.kind for e in rsa_events]
        assert kinds[:3] == ["plan", "rdm", "scores"] and kinds[-1] == "done"
        lo = 0
        for ev in rsa_events:
            if ev.kind != "null":
                continue
            block = ev.payload
            assert torch.equal(block, mono_rsa.null[:, lo:lo + block.shape[1]])
            lo += block.shape[1]
        assert_responses_equal(rsa_events[-1].payload, mono_rsa)


# ---------------------------------------------------------------------------
# Error paths: structured JSON, engine untouched
# ---------------------------------------------------------------------------


def _engine_fingerprint(engine):
    s = engine.stats()
    return (s["compiles"], s["plans_built"], s["labels_evaluated"])


def test_error_paths_are_structured_and_leave_engine_untouched(problem):
    x, y, _, f = problem
    with _edge(max_body_bytes=1 << 20) as edge, HTTPClient(edge.url) as hc:
        handle = _register_over_wire(hc, problem)
        hc.submit(Workload(kind="cv", dataset=handle, y=y))  # prime/warm
        before = _engine_fingerprint(edge.engine)

        # malformed JSON
        status, body = _raw_request(edge, b"{this is not json")
        assert status == 400 and body["error"]["type"] == "bad_json"

        # unknown schema version (the eager from_dict validation message)
        d = Workload(kind="cv", dataset=handle, y=y).to_dict()
        d["schema"] = 99
        status, body = _raw_request(edge, json.dumps(d).encode())
        entry = body["results"][0]
        assert status == 200 and not entry["ok"]
        assert entry["error"]["status"] == 400
        assert "unsupported workload schema" in entry["error"]["message"]
        # ...and on the stream route, which rejects before any SSE bytes
        status, body = _raw_request(edge, json.dumps(d).encode(), path="/v1/workloads/stream")
        assert status == 400 and body["error"]["type"] == "validation"
        assert "unsupported workload schema" in body["error"]["message"]

        # eager Workload validation message travels verbatim
        bad = Workload(kind="cv", dataset=handle, y=y).to_dict()
        bad["y"]["__array__"] = [2.0] * N  # not ±1-coded
        status, body = _raw_request(edge, json.dumps(bad).encode())
        entry = body["results"][0]
        assert status == 200 and not entry["ok"]
        assert "±1" in entry["error"]["message"]
        assert entry["error"]["status"] == 400

        # unknown handle
        fake = DatasetHandle(key=("bogus", "te", "tr", 1.0, "dual", True), n=N, p=P, lam=LAM)
        with pytest.raises(WireError, match="not registered") as ei:
            hc.submit(Workload(kind="cv", dataset=fake, y=y))
        assert ei.value.status == 404 and ei.value.etype == "unknown_dataset"

        # evicted + deregistered handle
        h2 = hc.register(x * 1.25, (f.te_idx.numpy(), f.tr_idx.numpy()), LAM)
        edge.engine.evict(h2, deregister=True)
        with pytest.raises(WireError, match="not registered") as ei:
            hc.submit(Workload(kind="cv", dataset=h2, y=y))
        assert ei.value.status == 404

        # oversized body: rejected from Content-Length alone — the edge
        # answers without reading a single body byte (none is ever sent)
        status, raw = _raw(edge.port, (f"POST /v1/workloads HTTP/1.1\r\nHost: t\r\n"
                                       f"Content-Length: {(1 << 20) + 1}\r\n\r\n").encode())
        assert status == 413 and json.loads(raw)["error"]["type"] == "oversized"

        # chunked request bodies: explicit 411, not a desynced parser
        status, raw = _raw(edge.port, b"POST /v1/workloads HTTP/1.1\r\nHost: t\r\n"
                                      b"Transfer-Encoding: chunked\r\n\r\n5\r\nhello\r\n0\r\n\r\n")
        assert status == 411 and json.loads(raw)["error"]["type"] == "length_required"

        # unknown routes / methods
        status, body = _raw_request(edge, b"{}", path="/v1/nonsense")
        assert status == 404 and body["error"]["type"] == "not_found"

        assert _engine_fingerprint(edge.engine) == before
        # the edge counted its errors, and stays fully serviceable
        assert hc.stats()["edge"]["http_errors"] >= 5
        assert hc.healthz() == {"status": "ok"}


def test_expect_100_continue_handshake(problem):
    """curl adds `Expect: 100-continue` to >1KB POSTs (any real dataset
    registration) and stalls ~1s unless the edge answers the interim 100."""
    x, y, _, f = problem
    with _edge() as edge, HTTPClient(edge.url) as hc:
        handle = _register_over_wire(hc, problem)
        body = json.dumps(Workload(kind="cv", dataset=handle, y=y).to_dict()).encode()
        with socket.create_connection(("127.0.0.1", edge.port), timeout=60) as s:
            s.sendall((f"POST /v1/workloads HTTP/1.1\r\nHost: t\r\n"
                       f"Expect: 100-continue\r\nContent-Length: {len(body)}\r\n\r\n").encode())
            interim = s.recv(1024)
            assert interim.startswith(b"HTTP/1.1 100 Continue")
            s.sendall(body)
            raw = _recv_response(s, interim.partition(b"\r\n\r\n")[2])
        assert raw.split(b" ", 2)[1] == b"200"
        out = json.loads(raw.partition(b"\r\n\r\n")[2].decode())
        assert out["results"][0]["ok"] is True


def test_client_disconnect_mid_stream_keeps_serving(problem):
    x, y, _, f = problem
    with _edge(stream_chunk=8) as edge, HTTPClient(edge.url) as hc:
        handle = _register_over_wire(hc, problem)
        w = Workload(kind="permutation", dataset=handle, y=y, n_perm=40, seed=1)
        full = list(hc.stream(w))  # prime: every chunk shape served
        compiles = edge.engine.compile_count()

        # a client that reads the headers plus a little and hangs up
        body = json.dumps(w.to_dict()).encode()
        with socket.create_connection(("127.0.0.1", edge.port), timeout=60) as s:
            s.sendall(_post(body, path="/v1/workloads/stream"))
            s.recv(1024)

        # the edge survives: same stream again, bit-identical, no new shape
        again = list(hc.stream(w))
        assert [e.kind for e in again] == [e.kind for e in full]
        assert torch.equal(again[-1].payload.null, full[-1].payload.null)
        assert edge.engine.compile_count() == compiles
        assert hc.healthz() == {"status": "ok"}


# ---------------------------------------------------------------------------
# Per-workload failures never abort siblings (both transports)
# ---------------------------------------------------------------------------


def _bad_handle():
    return DatasetHandle(key=("bogus", "te", "tr", 1.0, "dual", True), n=N, p=P, lam=LAM)


def test_gather_surfaces_per_entry_errors_in_process(problem):
    import asyncio

    x, y, yc, f = problem
    engine = _engine()
    client = Client(engine)
    handle = client.register(x, f, LAM)
    good1 = Workload(kind="cv", dataset=handle, y=y)
    bad = Workload(kind="cv", dataset=_bad_handle(), y=y)
    good2 = Workload(kind="cv", dataset=handle, y=yc, estimator="multiclass", num_classes=3)
    ref1, ref2 = client.submit(good1), client.submit(good2)

    for transport in ("sync", "thread", "async"):
        if transport == "async":
            async def drive():
                async with Client(engine, transport="async") as ac:
                    return await ac.gather([good1, bad, good2], return_errors=True)

            out = asyncio.run(drive())
        elif transport == "thread":
            with Client(engine, transport="thread") as tc:
                out = tc.gather([good1, bad, good2], return_errors=True)
        else:
            out = client.gather([good1, bad, good2], return_errors=True)
        assert isinstance(out[1], KeyError), transport
        assert_responses_equal(out[0], ref1)
        assert_responses_equal(out[2], ref2)

    # default semantics unchanged: raise on the first failure
    with pytest.raises(KeyError, match="not registered"):
        client.gather([good1, bad, good2])


def test_http_gather_surfaces_per_entry_errors(problem):
    x, y, _, f = problem
    ref_client = Client(_engine())
    ref_handle = ref_client.register(x, f, LAM)
    ref = ref_client.submit(Workload(kind="cv", dataset=ref_handle, y=y))
    with _edge() as edge, HTTPClient(edge.url) as hc:
        handle = _register_over_wire(hc, problem)
        good = Workload(kind="cv", dataset=handle, y=y)
        bad = Workload(kind="cv", dataset=_bad_handle(), y=y)
        out = hc.gather([good, bad, good], return_errors=True)
        assert isinstance(out[1], WireError)
        assert out[1].status == 404 and "not registered" in str(out[1])
        # the two good siblings coalesced into one padded eval (width 2),
        # so compare at the concurrent-coalescing tolerance
        for got in (out[0], out[2]):
            assert type(got) is type(ref)
            _close(got.values, ref.values)
        with pytest.raises(WireError, match="not registered"):
            hc.gather([good, bad])


# ---------------------------------------------------------------------------
# Ops surface: registration, introspection, stats
# ---------------------------------------------------------------------------


def test_register_is_idempotent_and_introspectable_over_wire(problem):
    x, y, _, f = problem
    with _edge() as edge, HTTPClient(edge.url) as hc:
        h1 = _register_over_wire(hc, problem)
        h2 = _register_over_wire(hc, problem)
        assert h1 == h2 and h1.n == N and h1.p == P
        (info,) = hc.datasets()
        assert info["handle"] == h1 and info["resident"] is False
        hc.submit(Workload(kind="cv", dataset=h1, y=y))
        (info,) = hc.datasets()
        assert info["resident"] is True and info["served"] == 1

        s = hc.stats()
        assert s["engine"]["datasets_registered"] == 1
        assert s["server"]["requests_served"] == 1
        assert s["edge"]["http_requests"] >= 4


# ---------------------------------------------------------------------------
# Across packages: one wire format
# ---------------------------------------------------------------------------


def _error_requests(handle, y) -> dict:
    """Raw requests that each edge must refuse, by name."""
    cv = Workload(kind="cv", dataset=handle, y=y).to_dict()
    bad_schema = dict(cv, schema=99)
    bad_y = dict(cv, y={"__array__": [2.0] * N, "dtype": "float64"})
    unknown = Workload(kind="cv", dataset=_bad_handle(), y=y).to_dict()
    return {
        "bad_json": _post(b"{this is not json"),
        "bad_schema": _post(json.dumps(bad_schema).encode()),
        "bad_schema_stream": _post(json.dumps(bad_schema).encode(), "/v1/workloads/stream"),
        "validation": _post(json.dumps({"workloads": [bad_y, {"kind": "nonsense"}, 3]}).encode()),
        "unknown_handle": _post(json.dumps(unknown).encode()),
        "not_a_list": _post(json.dumps({"workloads": 3}).encode()),
        "register_body": _post(b"{}", "/v1/datasets"),
        "append_body": _post(b"{}", "/v1/datasets/abc/append"),
        "no_route": _post(b"{}", "/v1/nonsense"),
        "no_get_route": b"GET /v1/nope HTTP/1.1\r\nHost: t\r\n\r\n",
        "method": b"PUT /v1/workloads HTTP/1.1\r\nHost: t\r\nContent-Length: 0\r\n\r\n",
        "oversized": (b"POST /v1/workloads HTTP/1.1\r\nHost: t\r\n"
                      b"Content-Length: %d\r\n\r\n" % ((1 << 20) + 1)),
        "chunked": (b"POST /v1/workloads HTTP/1.1\r\nHost: t\r\n"
                    b"Transfer-Encoding: chunked\r\n\r\n5\r\nhello\r\n0\r\n\r\n"),
    }


def test_the_wire_is_one_format_across_packages(problem):
    """The port's HTTPClient against the reference's edge, the reference's
    HTTPClient against the port's edge: the same workloads served to ≤ 1e-9
    of the other package's in-process result, and byte-equal error bodies."""
    x, y, yc, f = problem
    pair = (f.te_idx.numpy(), f.tr_idx.numpy())
    port_engine = _engine()
    port_handle = port_engine.register(x, f, LAM)
    ref_engine = RefEngine()
    ref_handle = ref_engine.register(jnp.asarray(x), ref_folds.kfold(N, K, seed=1), LAM)
    assert port_handle.key == ref_handle.key
    names = ("cv/binary", "cv/ridge", "cv/multiclass", "cv/ridge_multi",
             "permutation/binary", "rsa/binary+models", "rsa/multiclass", "tune")
    pick = lambda matrix: [w for name, w in matrix if name in names]
    port_local = Client(port_engine).gather(pick(_workload_matrix(problem, port_handle)))
    ref_local = ref_serve(ref_engine, pick(_workload_matrix(problem, ref_handle, RefWorkload)))

    def held(got, want):
        for a, b in zip(got, want, strict=True):
            assert type(a).__name__ == type(b).__name__
            if hasattr(b, "values"):
                _close(a.values, b.values)
            elif hasattr(b, "observed"):
                _close(a.observed, b.observed)
            elif hasattr(b, "rdm"):
                _close(a.rdm, b.rdm)
                if b.model_scores is not None:
                    _close(a.model_scores, b.model_scores)
            else:
                _close(a.result.scores, b.result.scores)

    errors = {}
    with RefEdgeThread(max_body_bytes=1 << 20) as ref_edge, \
            _edge(max_body_bytes=1 << 20) as port_edge:
        # the port's client, the reference's server
        with HTTPClient(ref_edge.url) as hc:
            h = hc.register(x, pair, LAM)
            assert h.key == port_handle.key
            got = hc.gather(pick(_workload_matrix(problem, h)))
            assert isinstance(got[0].values, torch.Tensor)
            held(got, port_local)
            with pytest.raises(WireError, match="not registered"):
                hc.submit(Workload(kind="cv", dataset=_bad_handle(), y=y))
        # the reference's client, the port's server
        with RefHTTPClient(port_edge.url) as rc:
            h = rc.register(x, pair, LAM)
            assert h.key == ref_handle.key
            got = rc.gather(pick(_workload_matrix(problem, h, RefWorkload)))
            held(got, ref_local)
            h2 = rc.append(h, np.random.default_rng(3).normal(size=(K, P)))
            assert h2.version == 1 and h2.n == N + K
        for name, request in _error_requests(port_handle, y).items():
            errors[name] = (_raw(ref_edge.port, request), _raw(port_edge.port, request))
    for name, (ref_side, port_side) in errors.items():
        assert ref_side[0] >= 400 or b'"ok": false' in ref_side[1], name
        assert port_side == ref_side, name
