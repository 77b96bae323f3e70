"""reprolint core: file walker, rule registry, suppressions, vocab loading.

Everything here is stdlib-only on purpose: the checker AST-parses the
port's serving stack (including the vocabularies it enforces — ``STAGES``
from ``repro_torch/serve/trace.py``, ``METRICS`` from
``repro_torch/serve/obs.py``) instead of importing it, so it needs no torch
install and can never be broken by the code it is checking.
"""

from __future__ import annotations

import ast
import dataclasses
import functools
import json
import re
from pathlib import Path
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

#: Rule id reported for a suppression comment that carries no reason.
BAD_SUPPRESSION = "RL000"

# `# reprolint: ignore[RL001]` or `# reprolint: ignore[RL001,RL004] -- reason`
_SUPPRESS_RE = re.compile(
    r"#\s*reprolint:\s*ignore\[([A-Za-z0-9_\s,]+)\]\s*(?:--\s*(\S.*))?$"
)

#: In-file scope pragmas. A pragma on its own comment line marks the
#: innermost enclosing function (or the whole module when at top level).
PRAGMAS = ("host-path", "monotonic-time", "host-float64")
_PRAGMA_RE = re.compile(r"^\s*#\s*reprolint:\s*(host-path|monotonic-time|host-float64)\s*$")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One reported violation, pointing at a file:line."""

    rule: str
    path: str
    line: int
    col: int
    message: str

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def render(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule} {self.message}"


class Rule:
    """Base class for a reprolint rule: ``check(ctx)`` yields findings."""

    id = "RL???"
    title = ""

    def check(self, ctx: "FileContext") -> Iterator[Finding]:  # pragma: no cover
        raise NotImplementedError


@dataclasses.dataclass
class FileContext:
    """Parsed view of one file handed to every rule."""

    path: Path
    source: str
    tree: ast.Module
    lines: List[str]
    # line -> rule ids suppressed there (only suppressions WITH a reason)
    suppressions: Dict[int, set]
    # lines carrying an ignore[...] with no justification (RL000)
    bare_suppression_lines: List[int]
    # pragma directive -> list of line numbers where it appears
    pragma_lines: Dict[str, List[int]]
    # (start, end) line intervals of every function, innermost-last
    _func_spans: List[Tuple[int, int]] = dataclasses.field(default_factory=list)

    def finding(self, rule: str, node: ast.AST, message: str) -> Finding:
        return Finding(rule, str(self.path), node.lineno, node.col_offset, message)

    # -- pragma scoping ----------------------------------------------------

    def _spans(self) -> List[Tuple[int, int]]:
        if not self._func_spans:
            for node in ast.walk(self.tree):
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    self._func_spans.append((node.lineno, node.end_lineno or node.lineno))
        return self._func_spans

    def pragma_regions(self, directive: str) -> List[Tuple[int, int]]:
        """Line intervals governed by ``directive`` pragmas in this file.

        A pragma inside a function marks that function's full span
        (including nested functions); a top-level pragma marks the whole
        module. Returns [] when the file never opts in.
        """
        regions: List[Tuple[int, int]] = []
        for line in self.pragma_lines.get(directive, ()):
            inner: Optional[Tuple[int, int]] = None
            for start, end in self._spans():
                if start <= line <= end:
                    if inner is None or (start >= inner[0] and end <= inner[1]):
                        inner = (start, end)
            regions.append(inner if inner is not None else (1, len(self.lines)))
        return regions

    def in_region(self, directive: str, line: int) -> bool:
        return any(start <= line <= end for start, end in self.pragma_regions(directive))


def _scan_comments(lines: Sequence[str]):
    """Extract suppressions (with/without reason) and pragma lines."""
    suppressions: Dict[int, set] = {}
    bare: List[int] = []
    pragmas: Dict[str, List[int]] = {}
    for i, text in enumerate(lines, start=1):
        if "reprolint" not in text:
            continue
        m = _PRAGMA_RE.match(text)
        if m:
            pragmas.setdefault(m.group(1), []).append(i)
            continue
        m = _SUPPRESS_RE.search(text)
        if m:
            rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
            if m.group(2):
                suppressions.setdefault(i, set()).update(rules)
            else:
                bare.append(i)
    return suppressions, bare, pragmas


def parse_file(path: Path) -> Optional[FileContext]:
    source = path.read_text(encoding="utf-8")
    tree = ast.parse(source, filename=str(path))
    lines = source.splitlines()
    suppressions, bare, pragmas = _scan_comments(lines)
    return FileContext(path, source, tree, lines, suppressions, bare, pragmas)


# ---------------------------------------------------------------------------
# Vocabulary extraction (AST, not import — keeps the checker torch-free)
# ---------------------------------------------------------------------------


def _serve_dir() -> Path:
    return Path(__file__).resolve().parent.parent / "serve"


def _module_constant(path: Path, name: str):
    """literal_eval the module-level ``name = <literal>`` assignment."""
    tree = ast.parse(path.read_text(encoding="utf-8"), filename=str(path))
    for node in tree.body:
        targets = []
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets = [node.target]
        if any(isinstance(t, ast.Name) and t.id == name for t in targets):
            return ast.literal_eval(node.value)
    raise LookupError(f"{name} not found as a literal assignment in {path}")


@functools.lru_cache(maxsize=None)
def load_stages() -> Tuple[str, ...]:
    """The fixed trace-stage vocabulary (``serve/trace.py:STAGES``)."""
    return tuple(_module_constant(_serve_dir() / "trace.py", "STAGES"))


@functools.lru_cache(maxsize=None)
def load_metrics() -> dict:
    """The central metric declarations (``serve/obs.py:METRICS``)."""
    return dict(_module_constant(_serve_dir() / "obs.py", "METRICS"))


# ---------------------------------------------------------------------------
# Registry + runner
# ---------------------------------------------------------------------------


def all_rules() -> List[Rule]:
    # Imported lazily to avoid a cycle (rule modules import this module).
    from repro_torch.analysis import rules_dtype, rules_host, rules_locks, rules_vocab

    rules: List[Rule] = []
    for mod in (rules_host, rules_vocab, rules_locks, rules_dtype):
        rules.extend(mod.RULES)
    return rules


def iter_py_files(paths: Iterable[str]) -> Iterator[Path]:
    for raw in paths:
        p = Path(raw)
        if p.is_dir():
            yield from sorted(x for x in p.rglob("*.py") if "__pycache__" not in x.parts)
        elif p.suffix == ".py":
            yield p


def check_file(path: Path, rules: Sequence[Rule]) -> List[Finding]:
    try:
        ctx = parse_file(path)
    except SyntaxError as e:
        return [Finding(BAD_SUPPRESSION, str(path), e.lineno or 1, 0, f"syntax error: {e.msg}")]
    findings: List[Finding] = []
    for rule in rules:
        for f in rule.check(ctx):
            # A suppression only counts with a written justification; a
            # bare ignore[...] suppresses nothing and is reported below.
            if rule.id in ctx.suppressions.get(f.line, ()):
                continue
            findings.append(f)
    for line in ctx.bare_suppression_lines:
        findings.append(
            Finding(
                BAD_SUPPRESSION,
                str(path),
                line,
                0,
                "suppression without a justification "
                "(write `# reprolint: ignore[RULE] -- <reason>`)",
            )
        )
    return findings


def run(paths: Iterable[str], rules: Optional[Sequence[Rule]] = None) -> List[Finding]:
    """Check every ``.py`` under ``paths``; return findings sorted by site."""
    rules = list(rules) if rules is not None else all_rules()
    findings: List[Finding] = []
    for path in iter_py_files(paths):
        findings.extend(check_file(path, rules))
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings


def render_human(findings: Sequence[Finding]) -> str:
    lines = [f.render() for f in findings]
    n = len(findings)
    lines.append(f"reprolint: {n} finding{'s' if n != 1 else ''}")
    return "\n".join(lines)


def render_json(findings: Sequence[Finding]) -> str:
    return json.dumps(
        {"findings": [f.to_dict() for f in findings], "count": len(findings)}, indent=2
    )
