"""RL002 trace-stage vocabulary + RL003 metrics discipline.

Both rules check string-literal call sites against vocabularies that are
AST-extracted from their single source of truth (never duplicated in the
checker): ``STAGES`` in ``serve/trace.py`` and ``METRICS`` in
``serve/obs.py``. A typo'd stage or metric name therefore cannot drift
silently — it either matches the declaration or fails lint.
"""

from __future__ import annotations

import ast
from typing import Iterator, Optional

from repro_torch.analysis.core import FileContext, Finding, Rule, load_metrics, load_stages


def _literal_str(node: Optional[ast.AST]) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


class StageVocabulary(Rule):
    """Every stage literal handed to trace APIs must be a STAGES member."""

    id = "RL002"
    title = "trace-stage vocabulary: span/stage literals must come from STAGES"

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        stages = set(load_stages())
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            name = None
            f = node.func
            if isinstance(f, ast.Name):
                # core.spans.span("..."), called by its bare name in core
                if f.id == "span" and node.args:
                    name = _literal_str(node.args[0])
            elif isinstance(f, ast.Attribute):
                if f.attr in ("span", "shared") and node.args:
                    name = _literal_str(node.args[0])
                elif f.attr == "add" and len(node.args) == 2:
                    # Trace.add(stage, seconds) — two positional args keeps
                    # set.add()/argparse-style .add() out of scope.
                    name = _literal_str(node.args[0])
            if name is None:
                for kw in node.keywords:
                    if kw.arg == "stage":
                        name = _literal_str(kw.value)
            if name is not None and name not in stages:
                yield ctx.finding(
                    self.id,
                    node,
                    f"stage {name!r} is not in the STAGES vocabulary "
                    f"(repro_torch.serve.trace.STAGES: {', '.join(sorted(stages))})",
                )


_USE_KINDS = {"inc": "counter", "observe": "histogram"}
_REG_KINDS = {"counter": "counter", "gauge": "gauge", "histogram": "histogram"}

# Label-value expressions considered unbounded (cardinality bombs): any
# string formatting/construction at the call site. Names/attributes are
# assumed bounded — the runtime _other fold still backstops them.
def _is_unbounded_value(node: ast.AST) -> bool:
    if isinstance(node, ast.JoinedStr):
        return True
    if isinstance(node, ast.BinOp):
        return True  # "x-" + y, "x%s" % y, and friends
    if isinstance(node, ast.Call):
        f = node.func
        if isinstance(f, ast.Name) and f.id in {"str", "repr", "hex", "format"}:
            return True
        if isinstance(f, ast.Attribute) and f.attr in {"format", "join"}:
            return True
    return False


class MetricsDiscipline(Rule):
    """Metric names, label keys and label-value boundedness vs METRICS."""

    id = "RL003"
    title = "metrics discipline: call sites must match the central METRICS table"

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        metrics = load_metrics()
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call) or not isinstance(node.func, ast.Attribute):
                continue
            attr = node.func.attr
            if attr in _USE_KINDS:
                yield from self._check_use(ctx, node, attr, metrics)
            elif attr in _REG_KINDS:
                yield from self._check_registration(ctx, node, attr, metrics)

    def _check_use(self, ctx, node: ast.Call, attr: str, metrics: dict):
        name = _literal_str(node.args[0]) if node.args else None
        if name is None:
            return
        spec = metrics.get(name)
        if spec is None:
            yield ctx.finding(
                self.id,
                node,
                f"metric {name!r} has no declaration in repro_torch.serve.obs.METRICS",
            )
            return
        want_kind = _USE_KINDS[attr]
        if spec["kind"] != want_kind:
            yield ctx.finding(
                self.id,
                node,
                f".{attr}() needs a {want_kind} but {name!r} is declared "
                f"as a {spec['kind']}",
            )
        if any(kw.arg is None for kw in node.keywords):
            return  # **labels splat: keys unknowable statically
        keys = {kw.arg for kw in node.keywords}
        declared = set(spec.get("labels", ()))
        if keys != declared:
            yield ctx.finding(
                self.id,
                node,
                f"label keys {sorted(keys)} do not match the declared "
                f"label set {sorted(declared)} for {name!r}",
            )
        for kw in node.keywords:
            if kw.arg in declared and _is_unbounded_value(kw.value):
                yield ctx.finding(
                    self.id,
                    node,
                    f"label {kw.arg!r} value is built by string formatting "
                    "(unbounded cardinality); pass a value from a closed vocabulary",
                )

    def _check_registration(self, ctx, node: ast.Call, attr: str, metrics: dict):
        name = _literal_str(node.args[0]) if node.args else None
        if name is None:
            return
        spec = metrics.get(name)
        if spec is None:
            yield ctx.finding(
                self.id,
                node,
                f"metric {name!r} is registered but not declared in "
                "repro_torch.serve.obs.METRICS",
            )
            return
        if spec["kind"] != _REG_KINDS[attr]:
            yield ctx.finding(
                self.id,
                node,
                f"{name!r} is declared as a {spec['kind']} but registered "
                f"via .{attr}()",
            )
        for kw in node.keywords:
            if kw.arg == "labels":
                try:
                    got = tuple(ast.literal_eval(kw.value))
                except (ValueError, SyntaxError):
                    return
                if got != tuple(spec.get("labels", ())):
                    yield ctx.finding(
                        self.id,
                        node,
                        f"label keys {list(got)} do not match the declared "
                        f"label set {list(spec.get('labels', ()))} for {name!r}",
                    )


RULES = [StageVocabulary(), MetricsDiscipline()]
