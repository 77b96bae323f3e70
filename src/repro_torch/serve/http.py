"""repro_torch.serve.http — the HTTP/SSE edge over the Workload API.

:class:`~repro_torch.serve.workload.Workload` is wire-ready —
``to_dict``/``from_dict`` round-trip the versioned schema as plain JSON —
and this module is the wire. :class:`HTTPEdge` is an asyncio HTTP server
(stdlib ``asyncio`` streams; no new hard dependencies) mounted directly
on an :class:`~repro_torch.serve.aio.AsyncEngineServer`, so HTTP traffic
rides the same gather-window micro-batching, plan cache, and
shape-bucketed evals as in-process clients — the wire-conformance suite
(``tests/test_torch_http.py``) pins HTTP results *bit-identical* to the
in-process :class:`~repro_torch.serve.client.Client` for every workload
kind and every registered estimator, with no new launch shape once warm.

The wire format is the reference package's (``repro.serve.http``), byte
for byte: either package's :class:`HTTPClient` talks to the other's
:class:`HTTPEdge`. Decoded responses and progress events hold CPU tensors
(the wire has no device). Encoding a response copies its arrays from the
engine's device to the host (one synchronising copy per array); it runs
on the engine thread, never on the event loop.

Bits on the card: hat_apply splits its contraction by the batch width
(``kernels.hat_apply.hat_splits`` / ``dmma_hat_splits``), so a label
column served in bucket 8 and in bucket 64 may differ in its last bits.
Wire and in-process results are bit-identical where both coalesce the
same workloads into the same buckets; across bucket widths they agree to
f32 rounding. On the CPU the composite's results do not depend on the
bucket.

Routes (all payloads are JSON):

  ``POST /v1/workloads``         one workload object or ``{"workloads":
                                 [...]}``; each entry is served through
                                 the async gather window and answered
                                 with a **result-or-error** — one bad
                                 workload never aborts its siblings.
  ``POST /v1/workloads/stream``  one workload; the response is a
                                 Server-Sent-Events stream with one
                                 event per
                                 :class:`~repro_torch.serve.workload.ProgressEvent`
                                 — the *same* chunks, in the same order,
                                 as :func:`~repro_torch.serve.workload
                                 .stream_workload` (prefix-stable null
                                 chunks, identical draws to the
                                 monolithic path).
  ``POST /v1/datasets``          register a feature matrix + folds + λ
                                 into the engine's dataset registry;
                                 returns a
                                 :class:`~repro_torch.serve.workload.DatasetHandle`
                                 token so subsequent requests carry
                                 handles, not arrays.
  ``POST /v1/datasets/{fp}/append``  advance a registered dataset (append
                                 rows, retire rows, or both — the
                                 sliding window); ``{fp}`` is the
                                 handle's fingerprint prefix, the body
                                 carries the full handle plus ``x`` /
                                 ``drop_idx``; returns the version n+1
                                 handle.
  ``GET /v1/datasets``           the registry introspection view
                                 (including ``version``/``n_appended``
                                 per dataset).
  ``GET /v1/stats``              engine stats + async-server + edge
                                 counters.
  ``GET /v1/metrics``            Prometheus text exposition (format
                                 0.0.4) of the engine's metrics
                                 registry — counters, gauges, and
                                 per-stage latency histograms.
  ``GET /v1/trace``              last-``n`` finished request span trees
                                 (``?n=`` query, default 32) plus the
                                 per-stage p50/p95 summary; JSON.
  ``GET /healthz``               liveness.

Errors are structured JSON — ``{"error": {"type", "status", "message"}}``
— carrying the Workload validation message verbatim; malformed JSON,
unknown schema versions, unknown/evicted handles, and oversized bodies
are all rejected before any engine work, so ``stats()`` and
``compile_count()`` stay untouched. The body limit
(``DEFAULT_MAX_BODY_BYTES``, 64 MiB) keeps a full-width feature matrix
(787 × 76,000 f32 is ~1 GB as JSON) off the wire: register such data in
process and send labels, handles and appends.

:class:`HTTPClient` mirrors the in-process ``Client`` surface
(``register`` / ``submit`` / ``gather`` / ``stream`` / ``datasets`` /
``stats``) over stdlib ``http.client``, so examples and benchmarks swap
transports by construction. :class:`EdgeThread` runs an edge on a daemon
thread with its own event loop — the in-process harness used by the
conformance tests, the ``http_quickstart`` example, and ``chip_smoke.py``.

Deployment entry point: ``python -m repro_torch.launch.serve_cv --http PORT``
(composes with ``--warmup/--pin/--record-traffic``).
"""

from __future__ import annotations

import asyncio
import contextlib
import dataclasses
import http.client
import json
import threading
import time
import urllib.parse
from typing import Iterator, Optional

import numpy as np
import torch

# reprolint: monotonic-time
# (Edge decode/encode stage stamps — wall clocks would jump under NTP.)

from repro_torch.core import tuning
from repro_torch.serve.aio import AsyncEngineServer
from repro_torch.serve.engine import CVEngine
from repro_torch.serve.trace import attach_trace
from repro_torch.serve.workload import (
    CVResponse,
    DatasetHandle,
    DatasetSpec,
    GridResponse,
    PermutationResponse,
    ProgressEvent,
    RSAResponse,
    TuneResponse,
    UpdateResponse,
    Workload,
    _decode_array,
    _decode_dataset,
    _encode_array,
    _encode_dataset,
    _host,
    as_workload,
)

__all__ = [
    "HTTPEdge",
    "HTTPClient",
    "EdgeThread",
    "WireError",
    "response_to_dict",
    "response_from_dict",
    "event_to_dict",
    "event_from_dict",
    "assert_responses_equal",
]

DEFAULT_MAX_BODY_BYTES = 64 << 20

_REASONS = {
    200: "OK",
    400: "Bad Request",
    404: "Not Found",
    405: "Method Not Allowed",
    411: "Length Required",
    413: "Payload Too Large",
    500: "Internal Server Error",
}


# ---------------------------------------------------------------------------
# Wire codecs: responses and progress events <-> JSON-ready dicts
# ---------------------------------------------------------------------------


def _decode_tensor(d):
    """A wire array as a CPU tensor (``_decode_array`` gives NumPy)."""
    if d is None:
        return None
    return torch.from_numpy(_decode_array(d))


def response_to_dict(resp) -> dict:
    """JSON-ready form of any workload response (exact array round-trip).

    Arrays ride the same ``{"__array__": ..., "dtype": ...}`` encoding as
    :meth:`Workload.to_dict`; float64 values survive JSON bit-exactly
    (Python's float repr is shortest-round-trip), which is what the
    wire-conformance suite's bit-identical assertions rest on. Tensors on
    the card are copied to the host here.
    """
    if isinstance(resp, CVResponse):
        d = {
            "type": "cv",
            "task": resp.task,
            "values": _encode_array(resp.values),
            "y_te": _encode_array(resp.y_te),
            "score": _encode_array(resp.score),
            "plan_key": list(resp.plan_key),
        }
    elif isinstance(resp, PermutationResponse):
        d = {
            "type": "permutation",
            "observed": _encode_array(resp.observed),
            "null": _encode_array(resp.null),
            "p": _encode_array(resp.p),
            "plan_key": list(resp.plan_key),
        }
    elif isinstance(resp, RSAResponse):
        d = {
            "type": "rsa",
            "rdm": _encode_array(resp.rdm),
            "pair_values": _encode_array(resp.pair_values),
            "model_scores": _encode_array(resp.model_scores),
            "null": _encode_array(resp.null),
            "p": _encode_array(resp.p),
            "plan_key": list(resp.plan_key),
        }
    elif isinstance(resp, TuneResponse):
        r = resp.result
        d = {
            "type": "tune",
            "best_lambda": _encode_array(r.best_lambda),
            "best_score": _encode_array(r.best_score),
            "lambdas": _encode_array(r.lambdas),
            "scores": _encode_array(r.scores),
        }
    elif isinstance(resp, GridResponse):
        d = {"type": "grid", "accuracies": _encode_array(resp.accuracies)}
    elif isinstance(resp, UpdateResponse):
        d = {
            "type": "update",
            "handle": resp.handle.to_dict(),
            "version": int(resp.version),
            "appended": int(resp.appended),
            "dropped": int(resp.dropped),
            "rank": int(resp.rank),
            "plan_key": list(resp.plan_key),
        }
    else:
        raise TypeError(f"cannot encode response of type {type(resp).__name__}")
    # Optional, tracing-only: absent when tracing is off, so the wire
    # payload is byte-identical to the pre-observability schema (and the
    # conformance fields never include it).
    if getattr(resp, "timings", None) is not None:
        d["timings"] = resp.timings
    return d


def response_from_dict(d: dict):
    """Invert :func:`response_to_dict` back into the response dataclass
    (arrays as CPU tensors)."""
    t = d.get("type")
    if t == "cv":
        resp = CVResponse(
            d["task"],
            _decode_tensor(d["values"]),
            _decode_tensor(d["y_te"]),
            _decode_tensor(d["score"]),
            tuple(d["plan_key"]),
        )
    elif t == "permutation":
        resp = PermutationResponse(
            _decode_tensor(d["observed"]),
            _decode_tensor(d["null"]),
            _decode_tensor(d["p"]),
            tuple(d["plan_key"]),
        )
    elif t == "rsa":
        resp = RSAResponse(
            _decode_tensor(d["rdm"]),
            _decode_tensor(d["pair_values"]),
            _decode_tensor(d["model_scores"]),
            _decode_tensor(d["null"]),
            _decode_tensor(d["p"]),
            tuple(d["plan_key"]),
        )
    elif t == "tune":
        resp = TuneResponse(
            tuning.RidgeTuneResult(
                _decode_tensor(d["best_lambda"]),
                _decode_tensor(d["best_score"]),
                _decode_tensor(d["lambdas"]),
                _decode_tensor(d["scores"]),
            )
        )
    elif t == "grid":
        resp = GridResponse(_decode_tensor(d["accuracies"]))
    elif t == "update":
        resp = UpdateResponse(
            DatasetHandle.from_dict(d["handle"]),
            int(d["version"]),
            int(d["appended"]),
            int(d["dropped"]),
            int(d["rank"]),
            tuple(d["plan_key"]),
        )
    else:
        raise ValueError(f"unknown response type {t!r}")
    if "timings" in d:
        resp.timings = dict(d["timings"])
    return resp


def event_to_dict(ev: ProgressEvent) -> dict:
    """JSON-ready form of one streamed :class:`ProgressEvent`."""
    if ev.kind == "plan":
        payload = {"plan_key": list(ev.payload)}
    elif ev.kind == "done":
        payload = response_to_dict(ev.payload)
    elif ev.kind == "update":
        payload = dict(ev.payload)  # per-increment metrics delta: plain JSON
    else:
        payload = _encode_array(ev.payload)
    return {"kind": ev.kind, "done": ev.done, "total": ev.total, "payload": payload}


def event_from_dict(d: dict) -> ProgressEvent:
    kind = d["kind"]
    payload = d["payload"]
    if kind == "plan":
        payload = tuple(payload["plan_key"])
    elif kind == "done":
        payload = response_from_dict(payload)
    elif kind == "update":
        payload = dict(payload)
    else:
        payload = _decode_tensor(payload)
    return ProgressEvent(kind, int(d["done"]), int(d["total"]), payload)


_CONFORMANCE_FIELDS = (
    "values",
    "y_te",
    "score",
    "observed",
    "null",
    "p",
    "rdm",
    "pair_values",
    "model_scores",
    "accuracies",
)


def assert_responses_equal(got, want, label: str = "") -> None:
    """Assert two workload responses are bit-identical, field by field.

    The single equality contract the conformance harnesses check —
    tests/test_torch_http.py in-process and ``chip_smoke.py`` on the card
    — so a new response field cannot silently drop out of
    wire-conformance coverage in one of them. Arrays on any device (or
    NumPy) compare by value after a copy to the host.
    """
    prefix = f"{label}." if label else ""
    assert type(got) is type(want), f"{label}: {type(got).__name__} != {type(want).__name__}"
    for field in _CONFORMANCE_FIELDS:
        a, b = getattr(got, field, None), getattr(want, field, None)
        assert (a is None) == (b is None), f"{prefix}{field} presence"
        if a is not None:
            np.testing.assert_array_equal(_host(a), _host(b), err_msg=f"{prefix}{field}")
    if hasattr(want, "result"):
        for field in ("best_lambda", "best_score", "lambdas", "scores"):
            np.testing.assert_array_equal(
                _host(getattr(got.result, field)),
                _host(getattr(want.result, field)),
                err_msg=f"{prefix}result.{field}",
            )


# ---------------------------------------------------------------------------
# Structured errors
# ---------------------------------------------------------------------------


class WireError(RuntimeError):
    """A structured error answered by the HTTP edge.

    Carries the HTTP ``status``, the edge's error ``etype`` tag
    (``bad_json`` / ``validation`` / ``unknown_dataset`` / ``oversized`` /
    ``not_found`` / ``internal``), and the server-side message — for
    validation failures, the eager :class:`Workload` validation message
    verbatim.
    """

    def __init__(self, status: int, etype: str, message: str):
        super().__init__(message)
        self.status = int(status)
        self.etype = etype

    def __repr__(self) -> str:
        return f"WireError(status={self.status}, etype={self.etype!r}, message={str(self)!r})"


class _NotFound(Exception):
    pass


def _exc_message(e: BaseException) -> str:
    if isinstance(e, KeyError) and e.args:
        return str(e.args[0])
    return str(e) or type(e).__name__


def _classify(e: BaseException, phase: str = "decode") -> tuple:
    """(status, type) for an exception, by failure phase.

    ``phase="decode"`` covers everything before engine work — request
    parsing, JSON decoding, eager Workload validation — where a
    ValueError genuinely means the *client* sent something malformed.
    ``phase="serve"`` covers engine execution: inputs already passed the
    eager validators, so apart from unknown/evicted dataset handles a
    failure there is a server fault and reports as 500, not 400 — a
    client retrying a "validation" error that is really an engine bug
    could never succeed.
    """
    if isinstance(e, _NotFound):
        return 404, "not_found"
    if isinstance(e, KeyError) and "not registered" in _exc_message(e):
        return 404, "unknown_dataset"
    if phase == "decode":
        if isinstance(e, (json.JSONDecodeError, UnicodeDecodeError)):
            return 400, "bad_json"
        if isinstance(e, (KeyError, ValueError, TypeError)):
            return 400, "validation"
    return 500, "internal"


def _error_entry(e: BaseException, phase: str = "decode") -> dict:
    status, etype = _classify(e, phase)
    return {"ok": False, "error": {"type": etype, "status": status, "message": _exc_message(e)}}


def _error_body(etype: str, status: int, message: str) -> dict:
    return {"error": {"type": etype, "status": status, "message": message}}


# ---------------------------------------------------------------------------
# The edge
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Request:
    method: str
    path: str
    headers: dict
    body: bytes
    oversized: int = 0
    chunked: bool = False


def _write_chunk(writer, data: bytes) -> None:
    writer.write(f"{len(data):X}\r\n".encode("latin-1") + data + b"\r\n")


def _sse_event_bytes(ev: ProgressEvent) -> bytes:
    data = json.dumps(event_to_dict(ev))
    return f"event: {ev.kind}\ndata: {data}\n\n".encode("utf-8")


class HTTPEdge:
    """asyncio HTTP/SSE server over an :class:`AsyncEngineServer`.

    One edge owns one engine and one async server: HTTP submissions land
    in the same gather window as in-process async clients, so wire
    traffic coalesces onto shared plans and shared padded evals. The
    edge performs *no* computation of its own — JSON decoding yields the
    exact :class:`Workload` the in-process path would construct, which
    is what makes the wire bit-conformant.

    ``record`` (a :class:`~repro_torch.serve.workload.TrafficLog`) notes every
    wire workload's (task, bucket) coordinates, so ``serve_cv
    --record-traffic`` / ``--warmup-from`` compose with the HTTP edge.
    """

    def __init__(
        self,
        engine: Optional[CVEngine] = None,
        host: str = "127.0.0.1",
        port: int = 0,
        *,
        max_batch: int = 64,
        gather_window_ms: float = 2.0,
        stream_chunk: int = 64,
        max_body_bytes: int = DEFAULT_MAX_BODY_BYTES,
        record=None,
    ):
        self.engine = engine if engine is not None else CVEngine()
        self.host = host
        self.port = port
        self.max_body_bytes = max_body_bytes
        self.record = record
        self.server = AsyncEngineServer(
            self.engine,
            max_batch=max_batch,
            gather_window_ms=gather_window_ms,
            stream_chunk=stream_chunk,
        )
        self._http: Optional[asyncio.AbstractServer] = None
        self._conn_tasks: set = set()
        self.http_requests = 0
        self.http_streams = 0
        self.http_errors = 0

    # -- lifecycle ---------------------------------------------------------

    async def start(self) -> "HTTPEdge":
        if self._http is not None:
            raise RuntimeError("edge already started")
        await self.server.start()
        try:
            self._http = await asyncio.start_server(self._handle, self.host, self.port)
        except BaseException:
            # e.g. EADDRINUSE: don't leak the engine worker/executor thread
            await self.server.stop()
            raise
        self.port = self._http.sockets[0].getsockname()[1]
        return self

    async def stop(self) -> None:
        if self._http is not None:
            self._http.close()
            await self._http.wait_closed()
            self._http = None
        # Idle keep-alive connections park in readline() forever; cancel
        # them so shutdown never strands a handler task.
        for task in list(self._conn_tasks):
            task.cancel()
        if self._conn_tasks:
            await asyncio.gather(*self._conn_tasks, return_exceptions=True)
        await self.server.stop()

    async def serve_forever(self) -> None:
        await self._http.serve_forever()

    async def __aenter__(self) -> "HTTPEdge":
        return await self.start()

    async def __aexit__(self, *exc) -> None:
        await self.stop()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def _note(self, w: Workload, stream_chunk: Optional[int] = None) -> None:
        if self.record is not None:
            self.record.record(w, self.engine.config.buckets, stream_chunk=stream_chunk)

    def _offload(self, fn, *args):
        """Run work on the engine's executor thread.

        Two invariants ride on this: engine state is only ever touched
        from one thread (registration inserts vs. stats/datasets reads),
        and the event loop never blocks on multi-MB JSON codecs or on
        copies between the host and the card — so concurrent SSE streams
        and health checks stay live while a big request is
        (de)serialised.
        """
        return self.server._run(fn, *args)

    # -- connection handling ----------------------------------------------

    async def _handle(self, reader, writer) -> None:
        task = asyncio.current_task()
        self._conn_tasks.add(task)
        try:
            while True:
                try:
                    req = await self._read_request(reader, writer)
                except (asyncio.IncompleteReadError, ValueError):
                    break  # torn request / over-long header line: drop quietly
                if req is None:
                    break
                keep = await self._dispatch(req, writer)
                await writer.drain()
                if not keep:
                    break
        except (ConnectionResetError, BrokenPipeError):
            pass
        finally:
            self._conn_tasks.discard(task)
            with contextlib.suppress(Exception):
                writer.close()
                await writer.wait_closed()

    async def _read_request(self, reader, writer) -> Optional[_Request]:
        line = await reader.readline()
        if not line:
            return None  # clean EOF between keep-alive requests
        parts = line.decode("latin-1").split()
        if len(parts) != 3:
            raise ValueError("malformed request line")
        method, path = parts[0].upper(), parts[1]
        headers: dict = {}
        while True:
            hline = await reader.readline()
            if hline in (b"\r\n", b"\n", b""):
                break
            name, _, value = hline.decode("latin-1").partition(":")
            headers[name.strip().lower()] = value.strip()
        if "chunked" in headers.get("transfer-encoding", "").lower():
            # No chunked request bodies: without a length the body would
            # desync the keep-alive parser. Flagged so dispatch answers a
            # structured 411 instead of misreading frames as requests.
            return _Request(method, path, headers, b"", chunked=True)
        length = int(headers.get("content-length") or 0)
        if length > self.max_body_bytes:
            return _Request(method, path, headers, b"", oversized=length)
        if length and "100-continue" in headers.get("expect", "").lower():
            # curl sends Expect for >1KB bodies and stalls ~1s waiting for
            # this interim response before transmitting the body
            writer.write(b"HTTP/1.1 100 Continue\r\n\r\n")
            await writer.drain()
        body = await reader.readexactly(length) if length > 0 else b""
        return _Request(method, path, headers, body)

    async def _dispatch(self, req: _Request, writer) -> bool:
        self.http_requests += 1
        path = req.path.split("?", 1)[0]
        if req.chunked:
            self.http_errors += 1
            self._respond(
                writer,
                411,
                _error_body(
                    "length_required",
                    411,
                    "chunked request bodies are not supported; send Content-Length",
                ),
                keep_alive=False,
            )
            return False
        if req.oversized:
            # The body was never read, so the connection cannot be reused —
            # and, by construction, the engine was never touched.
            self.http_errors += 1
            self._respond(
                writer,
                413,
                _error_body(
                    "oversized",
                    413,
                    f"request body of {req.oversized} bytes exceeds the "
                    f"{self.max_body_bytes}-byte limit",
                ),
                keep_alive=False,
            )
            return False
        try:
            if req.method == "GET":
                if path == "/healthz":
                    self._respond(writer, 200, {"status": "ok"})
                elif path == "/v1/stats":
                    # engine reads run on the engine thread, like every
                    # other engine touch (registration mutates dicts there)
                    self._respond(writer, 200, await self._offload(self._stats))
                elif path == "/v1/datasets":
                    self._respond(writer, 200, await self._offload(self._datasets_payload))
                elif path == "/v1/metrics":
                    # Prometheus text exposition; rendering walks every
                    # series under the registry lock, so it runs on the
                    # engine thread like any other engine-state read.
                    text = await self._offload(self.engine.metrics.render_prometheus)
                    self._respond(
                        writer,
                        200,
                        text.encode("utf-8"),
                        content_type="text/plain; version=0.0.4; charset=utf-8",
                    )
                elif path == "/v1/trace":
                    query = urllib.parse.parse_qs(req.path.partition("?")[2])
                    n = int(query.get("n", ["32"])[0])
                    self._respond(writer, 200, await self._offload(self._trace_payload, n))
                else:
                    raise _NotFound(f"no route for GET {path}")
                return True
            if req.method == "POST":
                if path == "/v1/workloads":
                    self._respond(writer, 200, await self._serve_batch(req.body))
                    return True
                if path == "/v1/datasets":
                    self._respond(writer, 200, await self._register(req.body))
                    return True
                if path.startswith("/v1/datasets/") and path.endswith("/append"):
                    fp = path[len("/v1/datasets/"):-len("/append")]
                    self._respond(writer, 200, await self._append(fp, req.body))
                    return True
                if path == "/v1/workloads/stream":
                    return await self._serve_stream(req.body, writer)
                raise _NotFound(f"no route for POST {path}")
            self.http_errors += 1
            self._respond(
                writer,
                405,
                _error_body("method_not_allowed", 405, f"{req.method} is not supported"),
            )
            return True
        except Exception as e:  # noqa: BLE001 - mapped to a structured error
            self.http_errors += 1
            status, etype = _classify(e)
            self._respond(writer, status, _error_body(etype, status, _exc_message(e)))
            return True

    def _respond(
        self,
        writer,
        status: int,
        payload,
        keep_alive: bool = True,
        content_type: str = "application/json",
    ) -> None:
        """Write one response; ``payload`` is a dict or pre-encoded bytes."""
        body = payload if isinstance(payload, bytes) else json.dumps(payload).encode("utf-8")
        head = (
            f"HTTP/1.1 {status} {_REASONS.get(status, 'OK')}\r\n"
            f"Content-Type: {content_type}\r\n"
            f"Content-Length: {len(body)}\r\n"
            f"Connection: {'keep-alive' if keep_alive else 'close'}\r\n"
            "\r\n"
        )
        writer.write(head.encode("latin-1") + body)

    # -- routes ------------------------------------------------------------

    @staticmethod
    def _decode_batch(body: bytes):
        """(results, live): error entries slotted, valid Workloads decoded."""
        payload = json.loads(body.decode("utf-8"))
        if isinstance(payload, dict) and "workloads" in payload:
            items = payload["workloads"]
            if not isinstance(items, list):
                raise ValueError("'workloads' must be a list of workload objects")
        elif isinstance(payload, dict):
            items = [payload]
        else:
            raise ValueError("body must be a workload object or {'workloads': [...]}")
        results: list = [None] * len(items)
        live = []
        for i, d in enumerate(items):
            try:
                if not isinstance(d, dict):
                    raise ValueError(f"workload entry {i} is not an object")
                live.append((i, Workload.from_dict(d)))
            except Exception as e:  # noqa: BLE001 - result-or-error per entry
                results[i] = _error_entry(e)
        return results, live

    async def _serve_batch(self, body: bytes) -> bytes:
        tracer = self.engine.tracer
        t0 = time.perf_counter() if tracer.enabled else 0.0
        results, live = await self._offload(self._decode_batch, body)
        if tracer.enabled:
            # Wire decode is shared by the whole batch; attribute the full
            # duration to each member (exact for the single-workload case,
            # which is how latency budgets are measured).
            dt_decode = time.perf_counter() - t0
            for _i, w in live:
                tr = tracer.trace()
                tr.add("decode", dt_decode)
                attach_trace(w, tr)
        self.http_errors += sum(r is not None for r in results)
        for _i, w in live:
            self._note(w)
        outs = await asyncio.gather(
            *(self.server.submit(w) for _, w in live), return_exceptions=True
        )
        self.http_errors += sum(isinstance(o, BaseException) for o in outs)

        def encode() -> bytes:
            # Traces are already finished by run_workloads, so the wire
            # encode goes straight into the stage histogram rather than a
            # span (the "encode" span inside the trace covers response
            # construction; this covers JSON serialisation).
            t_enc = time.perf_counter() if tracer.enabled else 0.0
            for (i, _), out in zip(live, outs):
                if isinstance(out, BaseException):
                    results[i] = _error_entry(out, phase="serve")
                else:
                    results[i] = {"ok": True, "response": response_to_dict(out)}
            encoded = json.dumps({"results": results}).encode("utf-8")
            if tracer.enabled:
                self.engine.metrics.observe(
                    "stage_latency_seconds", time.perf_counter() - t_enc, stage="encode"
                )
            return encoded

        return await self._offload(encode)

    @staticmethod
    def _decode_register(body: bytes) -> DatasetSpec:
        payload = json.loads(body.decode("utf-8"))
        if not isinstance(payload, dict) or "__dataset__" not in payload:
            raise ValueError(
                "register body must be an encoded dataset: "
                '{"__dataset__": {"x": {"__array__": ..., "dtype": ...}, '
                '"folds": {"te_idx": ..., "tr_idx": ...}, "lam": ..., "mode": ...}}'
            )
        ds = _decode_dataset(payload)
        if ds.x is None or ds.folds is None:
            raise ValueError("dataset registration needs both x and folds")
        return ds

    async def _register(self, body: bytes) -> dict:
        ds = await self._offload(self._decode_register, body)
        handle = await self.server.register(ds.x, ds.folds, ds.lam, mode=ds.mode)
        return {"handle": handle.to_dict()}

    @staticmethod
    def _decode_append(fp: str, body: bytes):
        payload = json.loads(body.decode("utf-8"))
        if not isinstance(payload, dict) or "handle" not in payload:
            raise ValueError(
                'append body must carry the full handle: {"handle": {...}, '
                '"x": <array|null>, "drop_idx": <array|null>}'
            )
        handle = DatasetHandle.from_dict(payload["handle"])
        if fp and not str(handle.key[0]).startswith(fp):
            raise ValueError(
                f"path fingerprint {fp!r} does not match the handle in the body "
                f"({str(handle.key[0])[:12]})"
            )
        x_new = payload.get("x")
        x_new = None if x_new is None else _decode_array(x_new)
        drop_idx = payload.get("drop_idx")
        drop_idx = None if drop_idx is None else _decode_array(drop_idx)
        folds_delta = payload.get("folds_delta")
        folds_delta = None if folds_delta is None else _decode_array(folds_delta)
        if x_new is None and drop_idx is None:
            raise ValueError("append body needs x (append), drop_idx (retire), or both")
        return handle, x_new, drop_idx, folds_delta

    async def _append(self, fp: str, body: bytes) -> dict:
        handle, x_new, drop_idx, folds_delta = await self._offload(self._decode_append, fp, body)
        new_handle = await self.server.append(
            handle, x_new, drop_idx=drop_idx, folds_delta=folds_delta
        )
        return {"handle": new_handle.to_dict()}

    @staticmethod
    def _decode_workload(body: bytes) -> Workload:
        return Workload.from_dict(json.loads(body.decode("utf-8")))

    async def _serve_stream(self, body: bytes, writer) -> bool:
        # Decode + validate *before* committing to SSE, so malformed input
        # gets a structured JSON error via the generic handler.
        tracer = self.engine.tracer
        t0 = time.perf_counter() if tracer.enabled else 0.0
        w = await self._offload(self._decode_workload, body)
        if tracer.enabled:
            tr = tracer.trace()
            tr.add("decode", time.perf_counter() - t0)
            attach_trace(w, tr)
        self._note(w, stream_chunk=self.server.stream_chunk)
        self.http_streams += 1
        head = (
            "HTTP/1.1 200 OK\r\n"
            "Content-Type: text/event-stream\r\n"
            "Cache-Control: no-cache\r\n"
            "Transfer-Encoding: chunked\r\n"
            "Connection: keep-alive\r\n"
            "\r\n"
        )
        writer.write(head.encode("latin-1"))
        gen = self.server.stream(w)
        try:
            async for ev in gen:
                # event encoding includes the full response on "done" —
                # potentially large, so it serialises off the loop too
                _write_chunk(writer, await self._offload(_sse_event_bytes, ev))
                await writer.drain()
        except (ConnectionResetError, BrokenPipeError):
            return False  # client went away mid-stream; stop computing chunks
        except Exception as e:  # noqa: BLE001 - headers are sent: error as SSE
            self.http_errors += 1
            status, etype = _classify(e, phase="serve")
            err = json.dumps(
                {
                    "kind": "error",
                    "error": {"type": etype, "status": status, "message": _exc_message(e)},
                }
            )
            _write_chunk(writer, f"event: error\ndata: {err}\n\n".encode("utf-8"))
        finally:
            await gen.aclose()
        _write_chunk(writer, b"")  # terminal chunk: the stream is complete
        await writer.drain()
        return True

    # -- introspection -----------------------------------------------------

    def _trace_payload(self, n: int) -> dict:
        tracer = self.engine.tracer
        return {
            "enabled": tracer.enabled,
            "ring": tracer.ring_size,
            "traces": tracer.last(n),
            "summary": tracer.summary(),
        }

    def _stats(self) -> dict:
        return {
            "engine": dict(self.engine.stats()),
            "server": {
                "batches_served": self.server.batches_served,
                "requests_served": self.server.requests_served,
                "streams_served": self.server.streams_served,
            },
            "edge": {
                "http_requests": self.http_requests,
                "http_streams": self.http_streams,
                "http_errors": self.http_errors,
            },
        }

    def _datasets_payload(self) -> dict:
        out = []
        for info in self.engine.datasets():
            d = dict(info)
            d["handle"] = info["handle"].to_dict()
            out.append(d)
        return {"datasets": out}


# ---------------------------------------------------------------------------
# In-process harness: an edge on a daemon thread with its own loop
# ---------------------------------------------------------------------------


class EdgeThread:
    """Run an :class:`HTTPEdge` on a daemon thread with its own event loop.

    The harness the wire-conformance tests, the ``http_quickstart``
    example, and ``chip_smoke.py`` use to get a live TCP edge while the
    caller stays synchronous (and keeps direct access to the underlying
    engine for compile-count / stats assertions). ``EdgeThread()`` with no
    engine builds ``CVEngine()``, which takes the card.
    """

    def __init__(self, engine: Optional[CVEngine] = None, **kwargs):
        self.edge = HTTPEdge(engine, **kwargs)
        self._started = threading.Event()
        self._stop: Optional[asyncio.Event] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._main, daemon=True, name="cv-http-edge")
        self._thread.start()
        started = self._started.wait(timeout=120)
        if self._error is not None:
            raise self._error
        if not started:
            raise RuntimeError("HTTP edge failed to start within 120s")

    def _main(self) -> None:
        self._loop = asyncio.new_event_loop()
        asyncio.set_event_loop(self._loop)
        try:
            self._loop.run_until_complete(self._serve())
        finally:
            self._loop.close()

    async def _serve(self) -> None:
        self._stop = asyncio.Event()
        try:
            await self.edge.start()
        except Exception as e:  # noqa: BLE001 - surfaced to the constructor
            self._error = e
            self._started.set()
            return
        self._started.set()
        await self._stop.wait()
        await self.edge.stop()

    def stop(self) -> None:
        if self._thread.is_alive() and self._loop is not None:
            with contextlib.suppress(RuntimeError):  # loop already closed
                self._loop.call_soon_threadsafe(self._stop.set)
            self._thread.join(timeout=120)

    def __enter__(self) -> "EdgeThread":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    @property
    def engine(self) -> CVEngine:
        return self.edge.engine

    @property
    def url(self) -> str:
        return self.edge.url

    @property
    def port(self) -> int:
        return self.edge.port


# ---------------------------------------------------------------------------
# The wire client: the Client surface over http.client
# ---------------------------------------------------------------------------


class HTTPClient:
    """Wire mirror of :class:`repro_torch.serve.client.Client`.

    ``register`` / ``append`` / ``retire`` / ``submit`` / ``gather`` /
    ``stream`` / ``datasets`` / ``stats`` have the same shapes as the
    in-process client — responses
    decode back into the same dataclasses, ``stream`` yields
    :class:`ProgressEvent`\\ s — so swapping an example or benchmark onto
    the wire is a constructor change. Batch submissions mirror
    ``Client.gather(..., return_errors=True)``: the edge answers
    result-or-error per entry, surfaced here as :class:`WireError`
    objects (or raised, for ``submit`` and plain ``gather``).

    Not mirrored: ``warmup`` (an operator-side engine API — warm over
    ``serve_cv --warmup``/``--warmup-from`` at boot instead).
    """

    def __init__(self, base_url: str, timeout: float = 300.0):
        u = urllib.parse.urlsplit(base_url if "//" in base_url else f"//{base_url}")
        if u.scheme not in ("", "http"):
            raise ValueError(f"only http:// is supported, got {u.scheme!r}")
        self.host = u.hostname or "127.0.0.1"
        self.port = u.port or 80
        self.timeout = timeout
        self._conn: Optional[http.client.HTTPConnection] = None

    # -- plumbing ----------------------------------------------------------

    def _connection(self) -> http.client.HTTPConnection:
        if self._conn is None:
            self._conn = http.client.HTTPConnection(self.host, self.port, timeout=self.timeout)
        return self._conn

    def close(self) -> None:
        if self._conn is not None:
            self._conn.close()
            self._conn = None

    def __enter__(self) -> "HTTPClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _request(self, method: str, path: str, payload=None, *, decode: bool = True):
        body = None if payload is None else json.dumps(payload).encode("utf-8")
        headers = {"Content-Type": "application/json"} if body is not None else {}
        resp = raw = None
        reused = self._conn is not None
        for attempt in (0, 1):
            conn = self._connection()
            try:
                conn.request(method, path, body=body, headers=headers)
                resp = conn.getresponse()
                raw = resp.read()
                break
            except TimeoutError:
                # The request may still be executing server-side: re-sending
                # a non-idempotent POST would double the engine work.
                self.close()
                raise
            except (http.client.HTTPException, ConnectionError, OSError):
                self.close()
                # Retry exactly once, and only when the failure is plausibly
                # a stale keep-alive connection (the server closed an idle
                # conn between our requests) — never on a fresh connection.
                if attempt or not reused:
                    raise
        try:
            data = json.loads(raw.decode("utf-8")) if raw else {}
        except ValueError:
            data = {}
        if resp.status >= 400:
            err = data.get("error", {}) if isinstance(data, dict) else {}
            raise WireError(
                resp.status, err.get("type", "http"), err.get("message", f"HTTP {resp.status}")
            )
        if not decode:  # non-JSON routes (e.g. Prometheus text)
            return raw.decode("utf-8")
        return data

    @staticmethod
    def _entry(entry: dict, raise_errors: bool):
        if entry.get("ok"):
            return response_from_dict(entry["response"])
        err = entry.get("error", {})
        exc = WireError(
            err.get("status", 500),
            err.get("type", "internal"),
            err.get("message", ""),
        )
        if raise_errors:
            raise exc
        return exc

    # -- the Client surface ------------------------------------------------

    def healthz(self) -> dict:
        return self._request("GET", "/healthz")

    def register(self, x, folds, lam: float, mode: str = "auto") -> DatasetHandle:
        """Register a dataset on the remote engine; returns its handle."""
        spec = DatasetSpec(x, folds, float(lam), mode)
        out = self._request("POST", "/v1/datasets", _encode_dataset(spec))
        return DatasetHandle.from_dict(out["handle"])

    def append(
        self, handle: DatasetHandle, x_new=None, *, drop_idx=None, folds_delta=None
    ) -> DatasetHandle:
        """Advance a registered dataset on the remote engine; returns the
        version n+1 handle. ``x_new`` alone appends, ``drop_idx`` alone
        retires, both slide the window (mirrors
        :meth:`CVEngine.update_dataset`)."""
        fp = str(handle.key[0])[:12]
        payload = {
            "handle": handle.to_dict(),
            "x": _encode_array(x_new),
            "drop_idx": _encode_array(drop_idx),
            "folds_delta": _encode_array(folds_delta),
        }
        out = self._request("POST", f"/v1/datasets/{fp}/append", payload)
        return DatasetHandle.from_dict(out["handle"])

    def retire(self, handle: DatasetHandle, idx) -> DatasetHandle:
        """Retire rows of a registered dataset on the remote engine."""
        return self.append(handle, None, drop_idx=idx)

    def datasets(self) -> tuple:
        out = self._request("GET", "/v1/datasets")["datasets"]
        return tuple({**d, "handle": DatasetHandle.from_dict(d["handle"])} for d in out)

    def stats(self) -> dict:
        """Remote stats: {"engine": ..., "server": ..., "edge": ...}."""
        return self._request("GET", "/v1/stats")

    def metrics_text(self) -> str:
        """Raw Prometheus text from ``GET /v1/metrics`` (format 0.0.4)."""
        return self._request("GET", "/v1/metrics", decode=False)

    def trace(self, n: int = 32) -> dict:
        """Last-``n`` span trees + per-stage summary from ``GET /v1/trace``."""
        return self._request("GET", f"/v1/trace?n={int(n)}")

    def submit(self, workload):
        """One workload in; its decoded response out (raises WireError)."""
        w = as_workload(workload)
        out = self._request("POST", "/v1/workloads", {"workloads": [w.to_dict()]})
        (entry,) = out["results"]
        return self._entry(entry, raise_errors=True)

    def gather(self, workloads, *, return_errors: bool = False) -> list:
        """Submit a batch; aligned responses (or WireError objects) out."""
        ws = [as_workload(w) for w in workloads]
        out = self._request("POST", "/v1/workloads", {"workloads": [w.to_dict() for w in ws]})
        return [self._entry(e, raise_errors=not return_errors) for e in out["results"]]

    def stream(self, workload) -> Iterator[ProgressEvent]:
        """SSE stream of one workload as decoded :class:`ProgressEvent`\\ s.

        Uses a dedicated connection so long streams don't block the
        client's keep-alive request connection.
        """
        w = as_workload(workload)
        return self._stream(w)

    def _stream(self, w: Workload) -> Iterator[ProgressEvent]:
        conn = http.client.HTTPConnection(self.host, self.port, timeout=self.timeout)
        try:
            conn.request(
                "POST",
                "/v1/workloads/stream",
                body=json.dumps(w.to_dict()).encode("utf-8"),
                headers={"Content-Type": "application/json"},
            )
            resp = conn.getresponse()
            if resp.status >= 400:
                raw = resp.read()
                try:
                    err = json.loads(raw.decode("utf-8")).get("error", {})
                except ValueError:
                    err = {}
                raise WireError(
                    resp.status, err.get("type", "http"), err.get("message", f"HTTP {resp.status}")
                )
            data_lines: list = []
            while True:
                line = resp.readline()
                if not line:
                    break
                text = line.decode("utf-8").rstrip("\r\n")
                if text.startswith("data:"):
                    data_lines.append(text[5:].lstrip())
                elif not text and data_lines:
                    d = json.loads("\n".join(data_lines))
                    data_lines = []
                    if d.get("kind") == "error":
                        err = d.get("error", {})
                        raise WireError(
                            err.get("status", 500),
                            err.get("type", "internal"),
                            err.get("message", ""),
                        )
                    ev = event_from_dict(d)
                    yield ev
                    if ev.kind == "done":
                        break
        finally:
            conn.close()
