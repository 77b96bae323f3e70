"""Driver: a library loop over a cohort of subjects.

Each subject analysis is the paper's pair of calls on one subject —
``core.fastcv.binary_cv`` and ``core.multiclass.analytical_cv_multiclass``
— ended by one synchronise; the loop cycles the cohort's subjects, made on
the device at set-up, until the window's time is up. The library keeps no
plan cache, so every analysis builds its plans.

Traffic parameters: ``subjects`` (cohort size), ``warmup_analyses``.
"""

from __future__ import annotations

import time

import torch

from harness import compare
from harness.bench import Number, Request
from harness.data import Subject
from reference.cv import FoldRidge


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def play(run) -> None:
    from repro_torch.core import fastcv, multiclass
    from repro_torch.core.folds import Folds

    cfg, traffic, dev = run.config, run.traffic, run.device
    c = cfg["num_classes"]
    subjects = [Subject(cfg, run.seed, i, dev) for i in range(traffic["subjects"])]
    folds = [Folds(s.te, s.tr, cfg["n_trials"]) for s in subjects]

    def analysis(i: int):
        s, f = subjects[i], folds[i]
        with run.span("binary_cv"):
            dvals, _ = fastcv.binary_cv(s.x, s.y, f, s.lam)
        with run.span("analytical_cv_multiclass"):
            pred, _ = multiclass.analytical_cv_multiclass(s.x, s.classes, f, c, s.lam)
        _sync(dev)
        return dvals, pred

    for _ in range(traffic["warmup_analyses"]):
        analysis(0)
    run.state = {"subjects": subjects, "answers": []}
    run.begin_window(_launch_counter())
    i = 0
    while True:
        req = Request("analysis", time.perf_counter(), extra={"subject": i % len(subjects)})
        run.requests.append(req)
        dvals, pred = analysis(req.extra["subject"])
        req.t1 = time.perf_counter()
        req.units = {"subjects": 1}
        run.state["answers"].append((req.extra["subject"], dvals, pred))
        run.trace_tick()
        i += 1
        if req.t1 >= run.deadline:
            break
    run.end_window()


def _launch_counter():
    from repro_torch.kernels import _build
    return _build.LAUNCH_SHAPES


def release(run) -> None:
    """Nothing of the program outlives the window but its answers."""


def answers(run) -> dict:
    return {"items": run.state["answers"]}


def reference(run, answers: dict, tf32: bool) -> dict:
    """Per subject of the answers: (decision values, squared centroid
    distances), in float64, or in float32 with TF32 products (the control)."""
    out = {}
    for s_idx in sorted({item[0] for item in answers["items"]}):
        s = run.state["subjects"][s_idx]
        ridge = FoldRidge(s.x, s.te, s.tr, s.lam, precision="tf32" if tf32 else "f64")
        out[s_idx] = (ridge.binary_dvals(s.y[:, None])[..., 0],
                      ridge.multiclass_distances(s.classes, run.config["num_classes"]))
        del ridge
    return out


def as_answers(run, answers: dict, ref: dict) -> dict:
    """The reference's results in the program's form (one item a subject)."""
    return {"items": [(s, dv, d2.argmin(dim=-1)) for s, (dv, d2) in ref.items()]}


def compare_answers(run, answers: dict, ref: dict) -> list[Number]:
    items = answers["items"]
    return [
        Number("dval_err", max(compare.dval_error(dv, ref[s][0]) for s, dv, _ in items),
               run.limit("dval_err")),
        Number("class_gap", max(compare.class_gap(pred, ref[s][1]) for s, _, pred in items),
               run.limit("class_gap")),
    ]
