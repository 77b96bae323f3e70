"""Driver: closed-loop coroutine clients over one ``AsyncEngineServer``.

Each client sends its next request once the last has returned, until the
window's time is up; requests in flight then finish, and the window ends
with the last of them. The server runs with the program's own defaults
(gather window, batch limit) on one ``CVEngine``. What a request is comes
from the traffic's ``request``, one ``_Kind`` each, which also holds the
request's check:

* ``permutation``: a binary permutation test (``n_perm`` draws, accuracy,
  a fresh seed from the run's seed and the request's index) against one of
  ``subjects`` registered subjects, round robin;
* ``grid``: a ``kind="grid"`` workload over every time point of one of
  ``subjects`` registered subjects, round robin;
* ``fresh``: register a subject that is not registered (from a pool of
  ``subjects``), run a binary and a multi-class ``kind="cv"`` workload on
  it together, then release it.

Set-up sends ``warmup_requests`` requests of the same kind, so every shape
of the window and the engine thread's libraries are warm.
"""

from __future__ import annotations

import asyncio
import collections
import random
import time

import torch

from harness import compare
from harness.bench import Number, Request
from harness.data import Subject, subseed
from reference.cv import FoldRidge, hits, uniform_permutations


def play(run) -> None:
    asyncio.run(_main(run))


async def _main(run) -> None:
    from repro_torch.kernels import _build
    from repro_torch.serve import AsyncEngineServer, CVEngine, EngineConfig

    traffic = run.traffic
    engine = CVEngine(EngineConfig(device=run.device))
    server = AsyncEngineServer(engine)
    kind = _KINDS[traffic["request"]](run, engine, server)
    run.state = {"engine": engine, "kind": kind, "answers": []}
    await server.start()
    try:
        await kind.setup()
        for r in range(traffic["warmup_requests"]):
            await kind.request(Request("warmup", time.perf_counter()), r, warm=True)
        if run.trace:
            engine.enable_tracing()
        before = _counters(engine)
        run.begin_window(_build.LAUNCH_SHAPES)
        issued = iter(range(traffic["warmup_requests"], 1 << 62))
        await asyncio.gather(*(_client(run, kind, issued) for _ in range(traffic["clients"])))
        after = _counters(engine)
        run.counters = {k: tuple(a - b for a, b in zip(after[k], before[k])) for k in after}
        run.end_window()
    finally:
        await server.stop()


async def _client(run, kind, issued) -> None:
    while time.perf_counter() < run.deadline:
        req = Request(kind.name, time.perf_counter())
        run.requests.append(req)
        try:
            await kind.request(req, next(issued))
        except Exception as e:  # noqa: BLE001 - a failed request is counted, not fatal
            req.ok = False
            req.extra["error"] = repr(e)
        req.t1 = time.perf_counter()
        run.trace_tick()


def _counters(engine) -> dict:
    occ = engine.metrics.get("gather_window_occupancy").snapshot()
    return {"gather_window_occupancy": (occ["count"], occ["sum"]),
            "labels_evaluated": (engine.labels_evaluated,),
            "plans_built": (engine.plans_built,)}


class _Kind:
    """One kind of request: set-up, the request itself, and its check —
    the reference's results, the control's answers, the numbers compared."""

    name = ""

    def __init__(self, run, engine, server):
        self.run, self.engine, self.server = run, engine, server
        self.subjects = [Subject(run.config, run.seed, i, run.device)
                         for i in range(run.traffic["subjects"])]

    @property
    def tested(self) -> int:
        """Test trials over the folds (the leftover trials always train)."""
        return self.run.config["folds"] * (self.run.config["n_trials"] // self.run.config["folds"])

    def folds(self, s):
        from repro_torch.core.folds import Folds
        return Folds(s.te, s.tr, self.run.config["n_trials"])

    async def submit(self, req: Request, workload):
        """Submit with the program's own trace attached when tracing is on;
        its spans go to the run's host spans, its stage sums to the request."""
        from repro_torch.serve import attach_trace

        tracer = self.engine.tracer
        trace = tracer.trace() if tracer.enabled else None
        t_trace = time.perf_counter()
        attach_trace(workload, trace)
        resp = await self.server.submit(workload)
        if trace is not None:
            _program_spans(self.run.spans, trace.to_dict()["spans"], t_trace)
            req.timings = dict(collections.Counter(req.timings or {})
                               + collections.Counter(resp.timings or {}))
        return resp

    def answers(self) -> dict:
        return {"items": self.run.state["answers"], "counters": self.run.counters,
                "requests": self.run.requests}

    def answered_subjects(self, answers: dict) -> list[int]:
        return sorted({item[0] for item in answers["items"]})


def _program_spans(out: list, spans: list, t0: float) -> None:
    for sp in spans:
        start = t0 + sp["start_s"]
        out.append((sp["name"], start, start + sp["duration_s"]))
        _program_spans(out, sp.get("children", []), t0)


class _Permutation(_Kind):
    """A binary permutation test. The check follows the program's own draws
    (``core.permutation.permutation_indices``, its documented prefix-stable
    draw, read after the window) to compare every null value with the
    reference's for the same labels, and checks the draw by itself, against
    no program code: each row a permutation and no row repeated; value-by-
    position counts as a uniform draw gives them; and the null's
    distribution against the reference's null over the benchmark's own
    uniform draws, per subject."""

    name = "permutation"

    async def setup(self):
        self.handles = [await self.server.register(s.x, self.folds(s), s.lam)
                        for s in self.subjects]
        # The check reads ``check_requests`` answers of the window, a uniform
        # sample drawn from the run's seed. They are drawn as the answers
        # come (reservoir sampling), so the window holds the program's
        # outputs of those requests alone. Holding every request's device
        # tensors (some 15,000 in a 51-s window on an H100) slowed the
        # engine by about a tenth and spread the runs.
        self.kept = _Reservoir(self.run.cell["check_requests"], subseed(self.run.seed, 4))

    async def request(self, req, r, warm=False):
        from repro_torch.serve import Workload

        i = r % len(self.subjects)
        seed = subseed(self.run.seed, 3, r)
        t = self.run.traffic["n_perm"]
        w = Workload(kind="permutation", dataset=self.handles[i], y=self.subjects[i].y,
                     estimator="binary", n_perm=t, seed=seed, metric="accuracy")
        resp = await self.submit(req, w)
        if not warm:
            req.units = {"perms": t}
            self.kept.offer(self.run.state["answers"], (i, seed, resp.observed, resp.null, resp.p))

    def answers(self) -> dict:
        """The answers sampled from the window, with the program's draws of
        those requests."""
        from repro_torch.core.permutation import permutation_indices

        out = super().answers()
        n, t = self.run.config["n_trials"], self.run.traffic["n_perm"]
        out["draws"] = {seed: permutation_indices(seed, n, t, device=self.run.device)
                        for _, seed, *_ in out["items"]}
        return out

    def reference(self, answers: dict, precision: str) -> dict:
        """Per checked request: decision values (K, m, 1 + T) of the observed
        labels and of each of the program's draws, and the labels; in
        float64 also the hits (T,) of T uniform draws of the benchmark's own."""
        ridges, out, own = {}, {}, {}
        n, t = self.run.config["n_trials"], self.run.traffic["n_perm"]
        for i, seed, *_ in answers["items"]:
            if seed not in answers["draws"]:
                continue
            s = self.subjects[i]
            if i not in ridges:
                ridges[i] = FoldRidge(s.x, s.te, s.tr, s.lam, precision=precision)
            blocks = [s.y[None], s.y[answers["draws"][seed]]]
            if precision == "f64":
                blocks.append(s.y[uniform_permutations(subseed(seed, 5), t, n, s.y.device)])
            labels = torch.cat(blocks).T                        # (N, 1 + T [+ T])
            dvals, y_te = ridges[i].binary_dvals(labels), labels[s.te.long()]
            out[seed] = (dvals[..., : 1 + t], y_te[..., : 1 + t])
            if precision == "f64":
                own[seed] = hits(dvals[..., 1 + t:], y_te[..., 1 + t:])
        return {"requests": out, "own": own}

    def as_answers(self, answers: dict, ref: dict) -> dict:
        items = []
        for i, seed, *_ in answers["items"]:
            if seed in ref["requests"]:
                acc = hits(*ref["requests"][seed]).to(torch.float32) / self.tested
                p = (1.0 + (acc[1:] >= acc[0]).sum().to(torch.float64)) / acc.shape[0]
                items.append((i, seed, acc[0], acc[1:], p))
        return {**answers, "items": items}

    def compare(self, answers: dict, ref: dict) -> list[Number]:
        gap, p_gap, invalid, drawn, nulls = 0.0, 0.0, 0, [], {}
        for i, seed, observed, null, p in answers["items"]:
            if seed not in answers["draws"]:
                continue
            prog = compare.hits_of(torch.cat([observed.reshape(1), null]), self.tested)
            gap = max(gap, compare.hit_gap(prog, *ref["requests"][seed]))
            implied = (1.0 + (null >= observed).sum().to(torch.float64)) / (1 + null.shape[0])
            p_gap = max(p_gap, float((p.to(torch.float64) - implied).abs()))
            draws = answers["draws"][seed]
            invalid += _invalid_rows(draws)
            drawn.append(draws)
            pair = nulls.setdefault(i, ([], []))
            pair[0].append(prog[1:])
            pair[1].append(ref["own"][seed])
        ks = max((compare.ks_distance(torch.cat(a), torch.cat(b)) for a, b in nulls.values()),
                 default=0.0)
        chi2 = compare.position_chi2(torch.cat(drawn)) if drawn else 0.0
        served = sum(r.units.get("perms", 0) for r in answers["requests"] if r.ok)
        run = self.run
        return [
            Number("null_gap", gap, run.limit("null_gap")),
            Number("null_ks", ks, run.limit("null_ks")),
            Number("draw_chi2", chi2, run.limit("draw_chi2")),
            Number("p_mismatch", p_gap, 0.0),
            Number("draws_invalid", float(invalid), 0.0),
            Number("labels_mismatch", abs(answers["counters"]["labels_evaluated"][0] - served), 0.0),
        ]

    def planted(self, answers: dict, fault: str) -> list[Number]:
        """The numbers of a biased draw put in the program's place: the
        float64 reference on the same requests, with ``DRAW_FAULTS[fault]``
        drawn for each checked request instead of the program's rows."""
        n, t = self.run.config["n_trials"], self.run.traffic["n_perm"]
        draws = {seed: DRAW_FAULTS[fault](subseed(seed, 6), t, n).to(self.run.device)
                 for seed in answers["draws"]}
        bad = {**answers, "draws": draws}
        ref = self.reference(bad, "f64")
        return self.compare(self.as_answers(bad, ref), ref)


class _Reservoir:
    """A uniform sample of ``size`` of the items offered, drawn from ``seed``
    as they come (Algorithm R): each of the first ``k`` items stays with
    probability ``size / k``."""

    def __init__(self, size: int, seed: int):
        self.size, self.offered = size, 0
        self.rng = random.Random(seed)

    def offer(self, kept: list, item) -> None:
        self.offered += 1
        if len(kept) < self.size:
            kept.append(item)
            return
        j = self.rng.randrange(self.offered)
        if j < self.size:
            kept[j] = item


def _invalid_rows(perms: torch.Tensor) -> int:
    """Rows that are not permutations of 0..N-1, plus repeated rows."""
    n = perms.shape[1]
    not_perm = (perms.sort(dim=1).values != torch.arange(n, device=perms.device)).any(dim=1)
    return int(not_perm.sum()) + perms.shape[0] - int(torch.unique(perms, dim=0).shape[0])


def _shifted_rows(seed: int, t: int, n: int) -> torch.Tensor:
    """Row k: one uniform permutation rotated by k places."""
    base = uniform_permutations(seed, 1, n, "cpu")[0]
    return torch.stack([base.roll(k) for k in range(t)])


def _half_shuffled(seed: int, t: int, n: int) -> torch.Tensor:
    """Each row shuffles the first half of the positions; the rest stay."""
    half = n // 2
    rows = torch.arange(n).repeat(t, 1)
    rows[:, :half] = uniform_permutations(seed, t, half, "cpu")
    return rows


def _few_swaps(seed: int, t: int, n: int) -> torch.Tensor:
    """Each row the identity with 8 random transpositions."""
    gen = torch.Generator().manual_seed(seed)
    rows = torch.arange(n).repeat(t, 1)
    pairs = torch.randint(0, n, (t, 8, 2), generator=gen)
    for k in range(8):
        a, b = pairs[:, k, 0:1], pairs[:, k, 1:2]
        va, vb = rows.gather(1, a), rows.gather(1, b)
        rows.scatter_(1, a, vb)
        rows.scatter_(1, b, va)
    return rows


#: biased draws that the draw's own checks have to catch (control.py)
DRAW_FAULTS = {"rows shifted": _shifted_rows, "half the positions shuffled": _half_shuffled,
               "8 swaps from the identity": _few_swaps}


class _Grid(_Kind):
    name = "grid"

    async def setup(self):
        # a subject registers with its first time point's features, which
        # carry its folds and λ; the grid itself travels in the workload
        self.handles = [await self.server.register(s.x[0], self.folds(s), s.lam)
                        for s in self.subjects]

    async def request(self, req, r, warm=False):
        from repro_torch.serve import Workload

        i = r % len(self.subjects)
        s = self.subjects[i]
        resp = await self.submit(req, Workload(kind="grid", dataset=self.handles[i],
                                               xs=s.x, y=s.y))
        if not warm:
            req.units = {"subjects": 1}
            self.run.state["answers"].append((i, resp.accuracies))

    def reference(self, answers: dict, precision: str) -> dict:
        """Per subject: decision values (K, m, Q) of every grid point, labels."""
        out = {}
        for i in self.answered_subjects(answers):
            s = self.subjects[i]
            y = s.y[:, None]
            dvals = torch.cat([FoldRidge(x, s.te, s.tr, s.lam, precision=precision)
                               .binary_dvals(y) for x in s.x], dim=-1)
            out[i] = (dvals, y[s.te.long()].expand_as(dvals))
        return out

    def as_answers(self, answers: dict, ref: dict) -> dict:
        items = [(i, hits(*pair).to(torch.float32) / self.tested) for i, pair in ref.items()]
        return {**answers, "items": items}

    def compare(self, answers: dict, ref: dict) -> list[Number]:
        gap = max(compare.hit_gap(compare.hits_of(acc, self.tested), *ref[i])
                  for i, acc in answers["items"])
        return [Number("grid_gap", gap, self.run.limit("grid_gap"))]


class _Fresh(_Kind):
    name = "fresh"

    async def setup(self):
        self.free = collections.deque(range(len(self.subjects)))

    async def request(self, req, r, warm=False):
        from repro_torch.serve import Workload

        i = self.free.popleft()
        s = self.subjects[i]
        try:
            t0 = time.perf_counter()
            handle = await self.server.register(s.x, self.folds(s), s.lam)
            t1 = time.perf_counter()
            self.run.spans.append(("register", t0, t1))
            req.extra["register_s"] = t1 - t0
            binary, multi = await asyncio.gather(
                self.submit(req, Workload(kind="cv", dataset=handle, y=s.y,
                                          estimator="binary")),
                self.submit(req, Workload(kind="cv", dataset=handle, y=s.classes,
                                          estimator="multiclass",
                                          num_classes=self.run.config["num_classes"])))
            self.engine.release(handle)
        finally:
            self.free.append(i)
        if not warm:
            req.units = {"subjects": 1}
            self.run.state["answers"].append((i, binary.values, multi.values))

    def reference(self, answers: dict, precision: str) -> dict:
        """Per subject: (decision values, squared centroid distances)."""
        out = {}
        for i in self.answered_subjects(answers):
            s = self.subjects[i]
            ridge = FoldRidge(s.x, s.te, s.tr, s.lam, precision=precision)
            out[i] = (ridge.binary_dvals(s.y[:, None])[..., 0],
                      ridge.multiclass_distances(s.classes, self.run.config["num_classes"]))
            del ridge
        return out

    def as_answers(self, answers: dict, ref: dict) -> dict:
        return {**answers, "items": [(i, dv, d2.argmin(dim=-1)) for i, (dv, d2) in ref.items()]}

    def compare(self, answers: dict, ref: dict) -> list[Number]:
        items, run = answers["items"], self.run
        started = sum(1 for r in answers["requests"] if r.kind == "fresh")
        return [
            Number("dval_err", max(compare.dval_error(dv, ref[i][0]) for i, dv, _ in items),
                   run.limit("dval_err")),
            Number("class_gap", max(compare.class_gap(p, ref[i][1]) for i, _, p in items),
                   run.limit("class_gap")),
            Number("plans_extra", abs(answers["counters"]["plans_built"][0] - started), 0.0),
        ]


_KINDS = {k.name: k for k in (_Permutation, _Grid, _Fresh)}


def release(run) -> None:
    """Free the engine (its plans and registered copies) before the check."""
    run.state["engine"] = None
    if run.device.type == "cuda":
        torch.cuda.empty_cache()


# -- the check, through the kind of request -------------------------------------

def answers(run) -> dict:
    return run.state["kind"].answers()


def reference(run, answers: dict, tf32: bool) -> dict:
    """The reference's results for the answers, in float64, or in float32
    with TF32 products (the control)."""
    return run.state["kind"].reference(answers, "tf32" if tf32 else "f64")


def as_answers(run, answers: dict, ref: dict) -> dict:
    """The control: the reference's results in the program's form, for the
    same requests."""
    return run.state["kind"].as_answers(answers, ref)


def compare_answers(run, answers: dict, ref: dict) -> list[Number]:
    return run.state["kind"].compare(answers, ref)
