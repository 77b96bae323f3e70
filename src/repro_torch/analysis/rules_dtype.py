"""RL005 host-float64 policy: no sub-float64 dtypes in declared regions.

The incremental plan math (``fastcv.update_plan`` / ``downdate_plan`` /
``sliding_window``, per arXiv 2401.13185) matches a from-scratch rebuild
*only because* every correction stays in IEEE float64. A single float32
cast in that lineage silently degrades the Woodbury corrections below
test tolerances. Files opt in with a ``# reprolint: host-float64`` pragma
(module- or function-scoped); inside the region it flags any sub-64-bit
float/complex dtype token — ``torch.float32`` / ``torch.float`` /
``torch.half`` / ``torch.bfloat16`` …, ``np.float32``, a string such as
``dtype="float32"`` — and the cast methods ``.float()``, ``.half()`` and
``.bfloat16()``.
"""

from __future__ import annotations

import ast
from typing import Iterator

from repro_torch.analysis.core import FileContext, Finding, Rule

SUB_F64_DTYPES = frozenset(
    {
        "float32",
        "float16",
        "bfloat16",
        "half",
        "single",
        "complex64",
    }
)

#: torch's own names of the sub-64-bit float and complex dtypes.
TORCH_SUB_F64 = frozenset(
    {"float32", "float", "float16", "half", "bfloat16", "complex64", "cfloat"}
)

#: Tensor methods that cast to a sub-64-bit float.
SUB_F64_CASTS = frozenset({"float", "half", "bfloat16"})

_NUMPY_ROOTS = {"np", "numpy"}


def _token(node: ast.AST):
    """The sub-float64 token ``node`` spells, or None."""
    if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name):
        root = node.value.id
        if root == "torch" and node.attr in TORCH_SUB_F64:
            return f"torch.{node.attr}"
        if root in _NUMPY_ROOTS and node.attr in SUB_F64_DTYPES:
            return f"{root}.{node.attr}"
    if isinstance(node, ast.Constant) and isinstance(node.value, str) \
            and node.value in SUB_F64_DTYPES:
        return repr(node.value)
    if (
        isinstance(node, ast.Call)
        and isinstance(node.func, ast.Attribute)
        and node.func.attr in SUB_F64_CASTS
        and not node.args
        and not node.keywords
    ):
        return f".{node.func.attr}()"
    return None


class HostFloat64(Rule):
    id = "RL005"
    title = "host-float64 policy: no sub-float64 dtypes in declared regions"

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        regions = ctx.pragma_regions("host-float64")
        if not regions:
            return
        for node in ast.walk(ctx.tree):
            token = _token(node)
            if token is None or not any(s <= node.lineno <= e for s, e in regions):
                continue
            yield ctx.finding(
                self.id,
                node,
                f"sub-float64 dtype {token} in a host-float64 region — the "
                "Woodbury update lineage is only exact in float64 "
                "(arXiv 2401.13185)",
            )


RULES = [HostFloat64()]
