"""paddle_tpu_torch.analysis — the runtime recompilation guard (the port
of ``paddle_tpu/analysis``'s ``trace_guard`` and ``findings``). The
jaxpr, AST, collective, concurrency and memory lints, the lock sentinel
and ``find_leaked_tracers`` wait with ``ROADMAP.md`` queue A item 7.
"""
from __future__ import annotations

from .findings import Finding, Report, Severity
from .trace_guard import DEFAULT_MAX_COMPILES, TraceGuard

__all__ = [
    "Finding", "Report", "Severity", "TraceGuard", "DEFAULT_MAX_COMPILES",
]
