"""Subgraph listing / counting (SgL).

Parity: src/sgl/ — pattern dispatched by name (omp_base.cc:16-52) to generated
kernels (cpu_kernels/{diamond,rectangle,house,pentagon}.h …). Device: named plans
from core.plan interpreted by the frontier engine.
"""
from __future__ import annotations

from ..core.pattern_graph import NAMED_PATTERNS, PatternGraph
from ..core.plan import SGL_PLANS, plan_from_pattern
from ..engine.frontier import count_pattern


#: patterns with a specialized fast engine (pattern name -> counter)
def _fast_engines():
    from ..ops.house import house_count_fast
    from ..ops.rectangle import rectangle_count_fast
    from ..ops.tri_support import diamond_count_fast
    return {"diamond": diamond_count_fast,
            "rectangle": rectangle_count_fast,
            "house": house_count_fast}


def sgl_count(g, pattern, chunk: int = 1024, backend: str = "auto",
              fast: bool = False) -> int:
    """Count a named pattern (hand-tuned plan when available, generated plan
    otherwise — the 'drop a generated kernel into cpu_kernels/' extension
    point of the reference, omp_base.cc:16-52, as a single function call).

    fast=True (or backend="fast") routes named patterns with a specialized
    engine (diamond → tri-support, rectangle → max-anchored codegree)."""
    if backend == "fast":
        fast, backend = True, "auto"
    if fast and isinstance(pattern, str):
        eng = _fast_engines().get(pattern.lower())
        if eng is not None:
            return eng(g)
    if isinstance(pattern, PatternGraph):
        plan = plan_from_pattern(pattern)
    elif pattern.startswith("@"):
        # pattern file (reference `sgl <graph> <pattern_file>` parity):
        # @/path/to/adj.txt or @codegen/input_patterns/<name> CSR dir
        pat = PatternGraph.from_file(pattern[1:])
        plan = plan_from_pattern(pat)
    else:
        key = pattern.lower()
        if key in SGL_PLANS:
            plan = SGL_PLANS[key]
        elif key in NAMED_PATTERNS:
            plan = plan_from_pattern(NAMED_PATTERNS[key], name=key)
        else:
            raise ValueError(
                f"unknown pattern {pattern!r}; have "
                f"{sorted(set(SGL_PLANS) | set(NAMED_PATTERNS))}")
    return count_pattern(g, plan, chunk=chunk, backend=backend)
