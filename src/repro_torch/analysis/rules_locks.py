"""RL004 lock discipline: ``_GUARDED_BY`` attrs only mutate under lock.

A lightweight *lexical* race detector — the check that must exist before
the ROADMAP's replica-fleet work multiplies the thread-safety surface.
Classes declare their concurrency contract as data::

    class PlanCache:
        _GUARDED_BY = {"_entries": "_lock", "stats": "_lock"}
        _LOCKED_HELPERS = ("_evict_over_budget",)  # callers hold _lock

Any mutation of ``self.<attr>`` (assignment, augmented assignment, item
assignment/deletion, or a mutating method call like ``.append``/``.pop``)
for an attr in ``_GUARDED_BY`` must sit lexically inside
``with self.<lock>``. ``__init__`` is exempt (no concurrent access before
construction completes), as are helpers named in ``_LOCKED_HELPERS`` —
the declared way to say "my callers hold the lock". Nested functions and
lambdas reset the held-lock state: they run later, possibly lock-free.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterator, Optional, Set, Tuple

from repro_torch.analysis.core import FileContext, Finding, Rule

#: Method names that mutate their receiver in-place.
MUTATORS = frozenset(
    {
        "append",
        "appendleft",
        "extend",
        "insert",
        "pop",
        "popitem",
        "popleft",
        "remove",
        "clear",
        "add",
        "discard",
        "update",
        "setdefault",
        "move_to_end",
        "sort",
        "reverse",
    }
)


def _self_attr_root(node: ast.AST) -> Optional[str]:
    """The ``<attr>`` in an expression rooted at ``self.<attr>``, else None.

    Walks down chains like ``self.stats.bytes_in_use`` or
    ``self._entries[key]`` to their base attribute on ``self``.
    """
    while isinstance(node, (ast.Attribute, ast.Subscript)):
        base = node.value
        if (
            isinstance(node, ast.Attribute)
            and isinstance(base, ast.Name)
            and base.id == "self"
        ):
            return node.attr
        node = base
    return None


def _class_literal(cls: ast.ClassDef, name: str):
    for stmt in cls.body:
        targets = []
        if isinstance(stmt, ast.Assign):
            targets = stmt.targets
        elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
            targets = [stmt.target]
        if any(isinstance(t, ast.Name) and t.id == name for t in targets):
            try:
                return ast.literal_eval(stmt.value)
            except (ValueError, SyntaxError):
                return None
    return None


class LockDiscipline(Rule):
    id = "RL004"
    title = "lock discipline: _GUARDED_BY attrs may only mutate under their lock"

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.ClassDef):
                guarded = _class_literal(node, "_GUARDED_BY")
                if not isinstance(guarded, dict) or not guarded:
                    continue
                helpers = set(_class_literal(node, "_LOCKED_HELPERS") or ())
                yield from self._check_class(ctx, node, guarded, helpers)

    def _check_class(
        self, ctx, cls: ast.ClassDef, guarded: Dict[str, str], helpers: Set[str]
    ):
        for stmt in cls.body:
            if not isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if stmt.name == "__init__" or stmt.name in helpers:
                continue
            for body_stmt in stmt.body:
                yield from self._walk(ctx, body_stmt, guarded, frozenset())

    # -- recursive walk tracking the set of held lock attrs ----------------

    def _walk(self, ctx, node: ast.AST, guarded, held: frozenset):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            # Closures execute later, possibly without the lock.
            body = node.body if isinstance(node.body, list) else [node.body]
            for child in body:
                yield from self._walk(ctx, child, guarded, frozenset())
            return
        if isinstance(node, (ast.With, ast.AsyncWith)):
            newly = {
                item.context_expr.attr
                for item in node.items
                if isinstance(item.context_expr, ast.Attribute)
                and isinstance(item.context_expr.value, ast.Name)
                and item.context_expr.value.id == "self"
            }
            for child in node.body:
                yield from self._walk(ctx, child, guarded, held | newly)
            return

        yield from self._check_node(ctx, node, guarded, held)
        for child in ast.iter_child_nodes(node):
            yield from self._walk(ctx, child, guarded, held)

    def _check_node(self, ctx, node: ast.AST, guarded, held: frozenset):
        sites = []  # (attr, verb)
        if isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            for t in targets:
                for el in self._flatten_target(t):
                    attr = _self_attr_root(el)
                    if attr in guarded:
                        sites.append((attr, "assigned"))
        elif isinstance(node, ast.Delete):
            for t in node.targets:
                attr = _self_attr_root(t)
                if attr in guarded:
                    sites.append((attr, "deleted"))
        elif isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
            if node.func.attr in MUTATORS:
                attr = _self_attr_root(node.func.value)
                if attr in guarded:
                    sites.append((attr, f"mutated via .{node.func.attr}()"))
        for attr, verb in sites:
            lock = guarded[attr]
            if lock not in held:
                yield ctx.finding(
                    self.id,
                    node,
                    f"self.{attr} is {verb} outside `with self.{lock}` "
                    f"(declared in _GUARDED_BY)",
                )

    @staticmethod
    def _flatten_target(t: ast.AST):
        if isinstance(t, (ast.Tuple, ast.List)):
            for el in t.elts:
                yield from LockDiscipline._flatten_target(el)
        else:
            yield t


RULES = [LockDiscipline()]
