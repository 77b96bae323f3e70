"""RL001 host hygiene: host paths stay off eager torch; timing stays monotonic.

Two sub-checks, both scoped by in-file pragmas:

* In ``# reprolint: host-path`` regions (the MicroBatcher coalescing
  path, the update-group assembly in workload.py / engine.py), any eager
  tensor *construction or assembly* op under ``torch.``,
  ``torch.nn.functional.`` or ``F.`` is flagged: each call is a device op
  of its own (an allocation, and on the card a kernel launch, per piece
  and per call), so a batch assembled piece by piece costs a launch per
  piece where one transfer would do. ``.item()`` is flagged too: it
  blocks the host until the device has caught up. ``torch.as_tensor`` and
  ``torch.from_numpy`` are allowed: they are the sanctioned way onto the
  device, as ``jnp.asarray`` is in the reference. Assemble in numpy, then
  enter the device once.
* In ``# reprolint: monotonic-time`` regions (batching, tracing, server
  gather loops), ``time.time()`` is flagged — wall clocks jump under
  NTP slew; use ``time.monotonic()``/``time.perf_counter()``.
"""

from __future__ import annotations

import ast
from typing import Iterator

from repro_torch.analysis.core import FileContext, Finding, Rule

# Eager construction/assembly ops, each a device op per call. (as_tensor
# and from_numpy are deliberately absent: the one sanctioned entry.)
TORCH_CHURN_OPS = frozenset(
    {
        "cat",
        "concat",
        "concatenate",
        "stack",
        "hstack",
        "vstack",
        "dstack",
        "column_stack",
        "row_stack",
        "tile",
        "repeat_interleave",
        "pad",
        "tensor",
        "zeros",
        "ones",
        "full",
        "empty",
        "arange",
        "linspace",
        "eye",
        "roll",
        "broadcast_to",
    }
)

_TORCH_ROOTS = {"torch", "F"}


def _is_torch(node: ast.AST) -> bool:
    """True for ``torch``, ``F`` or ``torch.nn.functional`` expression roots."""
    if isinstance(node, ast.Name):
        return node.id in _TORCH_ROOTS
    return (
        isinstance(node, ast.Attribute)
        and node.attr == "functional"
        and isinstance(node.value, ast.Attribute)
        and node.value.attr == "nn"
        and isinstance(node.value.value, ast.Name)
        and node.value.value.id == "torch"
    )


def _is_item(call: ast.Call) -> bool:
    f = call.func
    return isinstance(f, ast.Attribute) and f.attr == "item" and not call.args


def _is_time_time(call: ast.Call) -> bool:
    f = call.func
    return (
        isinstance(f, ast.Attribute)
        and f.attr == "time"
        and isinstance(f.value, ast.Name)
        and f.value.id == "time"
    )


class HostHygiene(Rule):
    id = "RL001"
    title = "host hygiene: no eager torch assembly / .item() / time.time() on declared host paths"

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        host = ctx.pragma_regions("host-path")
        mono = ctx.pragma_regions("monotonic-time")
        if not host and not mono:
            return
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            line = node.lineno
            f = node.func
            on_host = host and any(s <= line <= e for s, e in host)
            if (
                on_host
                and isinstance(f, ast.Attribute)
                and f.attr in TORCH_CHURN_OPS
                and _is_torch(f.value)
            ):
                yield ctx.finding(
                    self.id,
                    node,
                    f"eager torch {f.attr} on a declared host path is a device op per "
                    "call; assemble in numpy, then enter the device once via "
                    "torch.as_tensor",
                )
            if on_host and _is_item(node):
                yield ctx.finding(
                    self.id,
                    node,
                    ".item() on a declared host path blocks the host on the device; "
                    "keep the value on the device or read it once, outside the path",
                )
            if mono and _is_time_time(node) and any(s <= line <= e for s, e in mono):
                yield ctx.finding(
                    self.id,
                    node,
                    "time.time() in monotonic-time code (wall clocks jump); use "
                    "time.monotonic() or time.perf_counter()",
                )


RULES = [HostHygiene()]
