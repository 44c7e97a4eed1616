"""The active tracer: the context variables behind
``repro_torch.runtime.trace.active`` and ``activate``.

They live apart from :mod:`repro_torch.runtime.trace` so that the core
layers, which the runtime package imports, can read them without an import
cycle.  Stdlib only.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Any, Iterator, Optional

# The tracer recording now (a repro_torch.runtime.trace.Tracer), and the
# innermost open Tracer.span of this thread or task (the next span's parent).
ACTIVE: contextvars.ContextVar[Optional[Any]] = contextvars.ContextVar(
    "repro_torch_active_tracer", default=None)
OPEN: contextvars.ContextVar[Optional[Any]] = contextvars.ContextVar(
    "repro_torch_open_span", default=None)


def active() -> Optional[Any]:
    """The tracer recording now, or None."""
    return ACTIVE.get()


@contextlib.contextmanager
def activate(tracer: Optional[Any]) -> Iterator[Optional[Any]]:
    """Make ``tracer`` (None: no tracer) the active one for the block."""
    token = ACTIVE.set(tracer)
    try:
        yield tracer
    finally:
        ACTIVE.reset(token)
